from .model import SegHRNet  # noqa: F401
from .criterion import cross_entropy_seg, ohem_cross_entropy  # noqa: F401
