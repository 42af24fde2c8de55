from .anchors import generate_anchors, shift_anchors, post_process, a2j_loss  # noqa: F401
from .model import A2JHRNet  # noqa: F401
