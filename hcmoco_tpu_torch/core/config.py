"""Configuration of the port (counterpart of hcmoco_tpu/core/config.py).

The same HRNet stage specs, method presets and `resolve_config` as the JAX
package, with the TrainConfig fields the ported slice reads.  The TPU-only
fields (mesh, channel padding, paired encoders, Pallas switches) are left
out; tests/test_torch_config.py holds every field here to the JAX
package's defaults and resolved values.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class HRNetStageSpec:
    """One HRNet stage (reference: STAGE{2,3,4} blocks of the seg YAMLs)."""

    num_modules: int
    num_branches: int
    block: str  # 'BASIC' | 'BOTTLENECK'
    num_blocks: Tuple[int, ...]
    num_channels: Tuple[int, ...]
    fuse_method: str = "SUM"


@dataclass(frozen=True)
class HRNetConfig:
    """HRNetV2 backbone spec (official_hrnet.py:484-503): stem of two
    stride-2 3x3 convs to 64ch, stage1 of Bottlenecks, stages 2-4 of
    multi-branch BasicBlocks with SUM fusion."""

    width: int
    stage1: HRNetStageSpec
    stage2: HRNetStageSpec
    stage3: HRNetStageSpec
    stage4: HRNetStageSpec
    stem_channels: int = 64
    bn_momentum: float = 0.99  # flax convention = torch momentum 0.01

    @property
    def branch_channels(self) -> Tuple[int, ...]:
        return self.stage4.num_channels

    @property
    def total_channels(self) -> int:
        return sum(self.stage4.num_channels)


def _hrnet(width: int) -> HRNetConfig:
    c = (width, width * 2, width * 4, width * 8)
    return HRNetConfig(
        width=width,
        stage1=HRNetStageSpec(1, 1, "BOTTLENECK", (4,), (64,)),
        stage2=HRNetStageSpec(1, 2, "BASIC", (4, 4), c[:2]),
        stage3=HRNetStageSpec(4, 3, "BASIC", (4, 4, 4), c[:3]),
        stage4=HRNetStageSpec(3, 4, "BASIC", (4, 4, 4, 4), c),
    )


HRNET_W18 = _hrnet(18)
HRNET_W32 = _hrnet(32)
HRNET_W48 = _hrnet(48)

# width 4, one module / one block per stage: structurally identical to the
# real widths, for tests
HRNET_TINY = HRNetConfig(
    width=4,
    stage1=HRNetStageSpec(1, 1, "BOTTLENECK", (1,), (8,)),
    stage2=HRNetStageSpec(1, 2, "BASIC", (1, 1), (4, 8)),
    stage3=HRNetStageSpec(1, 3, "BASIC", (1, 1, 1), (4, 8, 16)),
    stage4=HRNetStageSpec(1, 4, "BASIC", (1, 1, 1, 1), (4, 8, 16, 32)),
)

HRNET_CONFIGS = {18: HRNET_W18, 32: HRNET_W32, 48: HRNET_W48, 4: HRNET_TINY}


@dataclass(frozen=True)
class MethodPreset:
    modal: str  # 'RGB' | 'CMC' | 'RGBD2S'
    jigsaw: bool
    mem: str  # 'bank' | 'moco' | 'bank+jointspri3d'
    aug: str  # 'A'..'E'
    head: str  # 'linear' | 'mlp'
    nce_t: float


# reference override_dict, base_options.py:12-22
METHOD_PRESETS = {
    "InsDis": MethodPreset("RGB", False, "bank", "A", "linear", 0.07),
    "CMC": MethodPreset("CMC", False, "bank", "C", "linear", 0.07),
    "MoCo": MethodPreset("RGB", False, "moco", "A", "linear", 0.07),
    "PIRL": MethodPreset("RGB", True, "bank", "A", "linear", 0.07),
    "MoCov2": MethodPreset("RGB", False, "moco", "B", "mlp", 0.2),
    "CMCv2": MethodPreset("CMC", False, "moco", "E", "mlp", 0.2),
    "InfoMin": MethodPreset("RGB", True, "moco", "D", "mlp", 0.15),
    "CMCRGBD2S": MethodPreset("RGBD2S", False, "bank", "C", "linear", 0.07),
    "CMCJointsPri3DRGBD2S": MethodPreset(
        "RGBD2S", False, "bank+jointspri3d", "C", "linear", 0.07
    ),
}


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration; field names and defaults as the JAX
    package's TrainConfig (options/base_options.py, train_options.py)."""

    # method / model
    method: str = "Customize"
    modal: str = "RGB"
    arch: str = "HRNet"
    width: int = 18
    head: str = "linear"
    feat_dim: int = 128
    in_channel_list: Tuple[int, ...] = (3, 3)
    linear_feat_map: bool = False
    pool_method: str = "mean"
    skeleton_meta_name: str = "mpii"
    jigsaw: bool = False

    # memory / contrast
    mem: str = "bank"
    nce_k: int = 16384
    nce_m: float = 0.5
    nce_t: float = 0.07
    modality_missing: bool = False
    # the counts NCE builds (bsz, n_data) intermediates; above this
    # dataset size the row-gather NCE is needed (not ported yet)
    counts_max_n_data: int = 131072

    # optimization
    epochs: int = 200
    batch_size: int = 256  # global batch size
    learning_rate: float = 0.03
    lr_decay_epochs: Tuple[int, ...] = (120, 160)
    lr_decay_rate: float = 0.1
    weight_decay: float = 1e-4
    momentum: float = 0.9
    cosine: bool = False
    warm: bool = False
    warmup_from: float = 0.01
    warm_epochs: int = 5

    # data
    aug: str = "C"
    crop_size: int = 320

    # HRNetPN point-cloud branch: the original depth frame size for the
    # back-projection intrinsics (Kinect, 424x512) and the points sampled
    # per cloud.  pn_remat (recompute the SA MLPs in the backward) is not
    # ported: the step raises on it.
    pn_ori_h: float = 424.0
    pn_ori_w: float = 512.0
    pn_num_points: int = 4096
    pn_remat: bool = False

    # precision / step structure
    microbatch: int = 1
    remat: bool = False
    compute_dtype: str = "bfloat16"  # params are always f32

    @property
    def hrnet(self) -> HRNetConfig:
        return HRNET_CONFIGS[self.width]

    @property
    def num_joints(self) -> int:
        return {"mpii": 16, "coco_reduce": 13}[self.skeleton_meta_name]


def resolve_config(cfg: TrainConfig) -> TrainConfig:
    """Apply the method preset and the warmup derivation
    (BaseOptions.override_options, base_options.py:168-177;
    TrainOptions.modify_options, train_options.py:49-64)."""
    if cfg.method in METHOD_PRESETS:
        p = METHOD_PRESETS[cfg.method]
        cfg = replace(cfg, modal=p.modal, jigsaw=p.jigsaw, mem=p.mem,
                      aug=p.aug, head=p.head, nce_t=p.nce_t)
    if cfg.modal == "CMC" and tuple(cfg.in_channel_list) == (3, 3):
        # CMC splits a 3-channel image into L|ab (build_backbone.py:87)
        cfg = replace(cfg, in_channel_list=(1, 2))
    warm = cfg.warm or cfg.batch_size > 256
    if not warm:
        return replace(cfg, warm=False)
    # warmup_to is recomputed from the same formula in train/schedules.py
    return replace(cfg, warm=True,
                   warm_epochs=10 if cfg.epochs > 500 else 5)
