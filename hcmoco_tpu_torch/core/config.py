"""Configuration of the port (counterpart of hcmoco_tpu/core/config.py).

The same HRNet stage specs, method presets and `resolve_config` as the JAX
package, with the TrainConfig fields the ported slice reads.  The TPU-only
fields (mesh, channel padding, paired encoders, Pallas switches) are left
out; tests/test_torch_config.py holds every field here to the JAX
package's defaults and resolved values, and RECIPES to its first- and
second-stage recipes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional, Tuple


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
    alpha: float = 0.999  # the moco key encoder's EMA (e <- a e + (1-a) p)
    beta: float = 0.5  # PIRL/CMC jigsaw weight: (1-b) instance + b jigsaw
    modality_missing: bool = False
    # stage 2 (mem='bank+jointspri3d'): the dense and joint losses'
    # temperature, the pixels soft-Pri3D draws per image, and the SCL
    # groups (0: one group a process, which is one group here)
    temperature: float = 0.07
    pri3d_num_samples_per_image: int = 400
    scl_groups: int = 0
    # the bank NCE's formulation (contrast/memory.py), one estimator:
    #   'counts' (default): negatives as per-row draw counts, a
    #     count-weighted logsumexp over the dense scores (no gather);
    #   'hybrid': dense scores + a scalar gather forward, a chunked
    #     row-gather backward (no scatter);
    #   'gather': chunked bank-row gather + bmm both ways;
    #   'dense': dense scores + torch.gather both ways (its backward
    #     scatter-adds).
    bank_logits: str = "counts"
    # counts/dense/hybrid build (bsz, n_data) intermediates; above this
    # dataset size the step switches to 'gather'
    counts_max_n_data: int = 131072
    dense_scores: bool = False  # alias of bank_logits='dense'

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

    # data (data/pipeline.py::build_contrast_source)
    dataset: str = ""
    data_folder: str = "./data"
    train_file_list: str = ""
    val_file_list: str = ""
    mpii_root: str = ""
    coco_root: str = ""
    seg_root: str = ""
    seg_file_list: str = ""
    seg_val_file_list: str = ""
    packed_dir: str = ""  # memmapped NTU pack (data/packed.py)
    aug: str = "C"
    crop_size: int = 320
    random_flip: bool = False
    not_use_weighted_sampler: bool = False
    # NTUSegJoint: blank one modality of the segmentation frames
    mask_seg_depth: bool = False
    mask_seg_rgb: bool = False

    # versatility / segmentation (cli/main_segmentor.py)
    n_class: int = 25
    supervise_type: int = 0  # 0: rgbd, 1: rgb, 2: depth, 3: none
    test_type: int = 0  # the validated head: 0 rgbd, 1 rgb, 2 depth
    cmc_loss_weights: float = 1.0
    other_loss_weights: float = 1.0

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

    # io (cli/main_contrast.py, train/checkpoint.py)
    model_path: str = "./save"
    resume: str = ""
    pretrain: Optional[str] = None
    save_freq: int = 20
    print_freq: int = 10
    seed: int = 0

    @property
    def model_name(self) -> str:
        # TrainOptions.modify_options naming (train_options.py:39-47)
        return (f"{self.method}_{self.arch}_{self.modal}_Jig_{self.jigsaw}_"
                f"{self.mem}_aug_{self.aug}_{self.head}_{self.nce_t}")

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


def _first_stage(**kw) -> TrainConfig:
    """The reference's FirstStage recipe (HRNet-W18, 320^2, K=16384)."""
    base = TrainConfig(method="CMCRGBD2S", arch="HRNet", width=18,
                       dataset="NTUMPII", batch_size=224, epochs=100,
                       learning_rate=0.03, cosine=True, nce_k=16384,
                       modality_missing=True, crop_size=320,
                       random_flip=True)
    return resolve_config(replace(base, **kw))


def _second_stage(**kw) -> TrainConfig:
    """The reference's SecondStage recipe: stage 1's plus the dense and
    joint losses over the linear_feat_map heads."""
    base = TrainConfig(method="CMCJointsPri3DRGBD2S", arch="HRNet", width=18,
                       dataset="NTUMPII", batch_size=224, epochs=100,
                       learning_rate=0.03, cosine=True, nce_k=16384,
                       modality_missing=True, linear_feat_map=True,
                       pri3d_num_samples_per_image=400, temperature=0.07,
                       crop_size=320, random_flip=True)
    return resolve_config(replace(base, **kw))


# the JAX package's FirstStage/, SecondStage/ and Versatility/ recipes
RECIPES = {
    "first_stage/ntumpiirgbd2s_hrnet_w18": _first_stage(),
    "first_stage/ntumpiirgbd2s_hrnet_w32": _first_stage(width=32),
    "first_stage/ntumpiirgbd2s_hrnet_w48": _first_stage(width=48),
    "first_stage/ntucocorgbd2s_hrnet_w18": _first_stage(
        dataset="NTUCOCO", skeleton_meta_name="coco_reduce"),
    "first_stage/ntumpiirgbd2s_hrnetpn_w18": _first_stage(arch="HRNetPN"),
    "second_stage/ntumpiirgbd2s_hrnet_w18": _second_stage(),
    "second_stage/ntumpiirgbd2s_hrnet_w32": _second_stage(width=32),
    "second_stage/ntumpiirgbd2s_hrnet_w48": _second_stage(width=48),
    "second_stage/ntucocorgbd2s_hrnet_w18": _second_stage(
        dataset="NTUCOCO", skeleton_meta_name="coco_reduce"),
    "second_stage/ntumpiirgbd2s_hrnetpn_w18": _second_stage(arch="HRNetPN"),
    # joint contrast + cross-modal supervised segmentation
    "versatility/sup_rgbd": _second_stage(
        dataset="NTUSeg", supervise_type=0, test_type=0),
    "versatility/sup_rgb_test_d": _second_stage(
        dataset="NTUSeg", supervise_type=1, test_type=2, mask_seg_depth=True),
    "versatility/sup_d_test_rgb": _second_stage(
        dataset="NTUSeg", supervise_type=2, test_type=1, mask_seg_rgb=True),
    "versatility/sup_none": _second_stage(
        dataset="NTUSeg", supervise_type=3, test_type=0),
}


def to_dict(cfg: TrainConfig) -> dict:
    return dataclasses.asdict(cfg)
