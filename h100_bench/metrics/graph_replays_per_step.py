"""Forward replays of the HRNet encoders' CUDA graphs a step: the
program's `encoder_graph` spans (one a replay, hcmoco_tpu_torch/train/
graphs.py) over the window's steps; None where the program recorded
none (a program without the graphs, or a window without a replay)."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from hcmoco_tpu_torch.utils import spans
    except ImportError:
        return None
    n = sum(1 for s in spans.recorded() if s.name == "encoder_graph")
    return n / ctx.steps if n else None
