"""The contrastive pre-training step (counterpart of
hcmoco_tpu/train/contrast_step.py): HCMoCo's stages 1 and 2 (`modal
'RGBD2S'`, `mem='bank'` and `mem='bank+jointspri3d'`), and the baselines
(`modal` 'RGB' or 'CMC') on memory banks (InsDis, PIRL, CMC) or on a MoCo
queue with an EMA key encoder (MoCo, MoCov2, CMCv2, InfoMin).

Behavioural spec: pycontrast/learning/contrast_trainer.py
`_train_mem_skeleton3d` (:532-640, stage 1): forward the tri-modal model,
six-way NCE against three memory banks, SGD step, bank EMA update; and
`_train_bank_joints_pri3d_cmc3` (:894-1039, stage 2), which adds the dense
soft-Pri3D, joint and cross-subject (SCL) losses over the stage-2 maps at
unit weight.

One process a device.  Under data parallelism (torch.distributed, see
parallel/mesh.py) rank r holds rows of the global batch and the step is
the JAX package's global step, held to a one-process step on the same
rows and draws: BN statistics are those of the global batch, the losses'
denominators are global (contrast/losses.py), negatives and pixels are
drawn for the global batch, the bank update takes every rank's features,
each rank's loss is its share of the global loss and the gradients are
summed over the ranks (one flattened all-reduce) before SGD, and the
metrics are the global ones.  `scl_groups` 0 takes one SCL group a rank
(the reference's per-GPU SCL; one group in a world of one).

Batch dict (the JAX package's field names; tensors on the model's device):
  rgbd (B, H, W, 6) f32 NHWC | index (B,) int | skeleton (B, J, 2) f32 |
  use_depth (B,) int | use_rgb (B,) int (optional) |
  counts (B, n_data) f32 (optional, the counts form: pins the negative
  draw as how often each bank row was drawn) | neg_idx (B, K+1) int
  (optional, the index form: pins the drawn rows, the positive in column
  0)
arch 'HRNetPN' also reads (dataset.py:1105-1118):
  depth_mask (B, H, W) f32 | grid_xy (B, H, W, 2) f32 | depth_mean (B,) f32 |
  pts_u (B, pn_num_points) f32 in [0, 1) (optional: pins the depth2pts
  draw; else the step's generator draws it)
the baselines (modal 'RGB' / 'CMC') read rgbd and index only, and:
  rgbd_jig (B, 9, h, w, C) f32 (with jigsaw: PIRL's patch stack) |
  jig_perm (B, 9) int (optional: pins each image's patch order; else the
  step's generator draws it) | neg_idx (B, K+1) int (optional, banks: pins
  the negatives); for mem='moco' rgbd holds the query and the key crop
  stacked on channels (B, H, W, 2C)
stage 2 also reads, for both archs:
  joints2d (B, J, 2) f32 full-resolution (row, col) | joints_vis (B, J) int |
  depth_mask (B, H, W) f32 | pix_idx (B, S) int (optional: pins the
  soft-Pri3D pixel draw, S = pri3d_num_samples_per_image; else the step's
  generator draws it)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..contrast.losses import (compute_loss_accuracy,
                               cross_subject_scl_loss, joints_pri3d_loss,
                               masked_six_way, nce_loss_and_acc,
                               per_sample_nce, scl_loss, scl_joint_features,
                               soft_pri3d_loss)
from ..contrast.memory import (cmc3_forward, cmc3_losses_counts,
                               memory_logits, moco_enqueue, moco_logits,
                               sample_negative_indices, update_memory)
from ..core.config import TrainConfig
from ..parallel.mesh import (all_reduce_grads, gather_rows, gather_rows_grad,
                             global_sum, my_rows, world_size)
from ..utils.spans import span
from . import graphs
from .remat import check_policy, recompute
from .schedules import learning_rate_fn
from .state import TrainState

_DIRECTIONS = ("12", "21", "23", "32", "13", "31")
# torchvision's ImageNet statistics, as hcmoco_tpu/data/transforms.py
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGE2_METRICS = ("loss_rgb2depth", "loss_depth2rgb", "acc_rgb2depth",
                  "acc_depth2rgb", "loss_rgb2joint", "loss_d2joint",
                  "acc_rgb2joint", "acc_d2joint", "loss_scl")


def device_normalize(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Raw uint8 rgb + uint16 depth-mm -> normalised f32 rgbd on device
    (transforms.normalize_rgb + depth/1000 x3, dataset.py:139-160)."""
    if "rgb_u8" not in batch:
        return batch
    batch = dict(batch)
    rgb = batch.pop("rgb_u8").float() / 255.0
    dev = rgb.device
    rgb = ((rgb - torch.as_tensor(IMAGENET_MEAN, device=dev))
           / torch.as_tensor(IMAGENET_STD, device=dev))
    d = batch.pop("depth_mm").float() / 1000.0
    batch["rgbd"] = torch.cat([rgb, d[..., None].expand(*d.shape, 3)], dim=-1)
    return batch


def _scl_grouped(lm1: torch.Tensor, lm2: torch.Tensor,
                 joints2d: torch.Tensor, use_depth: torch.Tensor,
                 use_rgb: torch.Tensor, temperature: float,
                 groups: int) -> torch.Tensor:
    """Cross-subject SCL, averaged over `groups` equal slices of the
    global batch (the reference computes it on each GPU's local batch);
    0 takes one group a rank.  Under data parallelism this is the rank's
    share of the mean: its own groups' losses over `groups` when each
    group lies on one rank, else (a group that spans ranks) the mean over
    every group of the gathered joint features, with their gradient, over
    the world size."""
    size = world_size()
    groups = groups or size
    if size > 1:
        if groups % size == 0:
            return _scl_sum(lm1, lm2, joints2d, use_depth, use_rgb,
                            temperature, groups // size) / groups
        rgb_j, d_j = (gather_rows_grad(t) for t in scl_joint_features(
            lm1, lm2, joints2d))
        ud, ur = gather_rows(use_depth), gather_rows(use_rgb)
        if rgb_j.shape[0] % groups:
            raise ValueError(f"scl_groups={groups} does not divide the "
                             f"batch of {rgb_j.shape[0]}")
        parts = zip(*(x.chunk(groups) for x in (rgb_j, d_j, ud, ur)))
        return torch.stack([scl_loss(*p, temperature)
                            for p in parts]).mean() / size
    if groups <= 1:
        return cross_subject_scl_loss(lm1, lm2, joints2d, use_depth, use_rgb,
                                      temperature)
    return _scl_sum(lm1, lm2, joints2d, use_depth, use_rgb, temperature,
                    groups, mean=True)


def _scl_sum(lm1, lm2, joints2d, use_depth, use_rgb, temperature: float,
             groups: int, mean: bool = False) -> torch.Tensor:
    """The sum (or mean) of the SCL losses of `groups` equal slices."""
    if lm1.shape[0] % groups:
        raise ValueError(f"scl_groups={groups} does not divide the batch of "
                         f"{lm1.shape[0]}")
    parts = zip(*(x.chunk(groups) for x in (lm1, lm2, joints2d, use_depth,
                                            use_rgb)))
    losses = torch.stack([cross_subject_scl_loss(*p, temperature)
                          for p in parts])
    return losses.mean() if mean else losses.sum()


def global_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Each rank's metrics are its shares of the global ones: their sum
    over the ranks, in one all-reduce; the metrics themselves in a world
    of one."""
    if world_size() == 1:
        return metrics
    names = list(metrics)
    total = global_sum(torch.stack([metrics[k].float() for k in names]))
    return dict(zip(names, total.unbind(0)))


def nce_mode(cfg: TrainConfig, n_data: int, pinned_idx: bool) -> str:
    """The bank NCE's formulation for a step (the JAX step's choice,
    hcmoco_tpu/train/contrast_step.py:206-223): cfg.bank_logits ('dense'
    if cfg.dense_scores); any mode but 'gather' builds (bsz, n_data)
    intermediates, so above counts_max_n_data the step takes 'gather';
    a pinned index draw (`neg_idx`) turns 'counts' into 'dense'."""
    mode = "dense" if cfg.dense_scores else cfg.bank_logits
    if mode not in ("counts", "dense", "hybrid", "gather"):
        raise ValueError(f"bank_logits: unknown mode {mode!r}")
    if mode != "gather" and n_data > cfg.counts_max_n_data:
        mode = "gather"
    if mode == "counts" and pinned_idx:
        mode = "dense"
    return mode


def _split(batch: Dict[str, torch.Tensor], n: int):
    """n equal microbatches of a batch dict, along dim 0."""
    bsz = batch["index"].shape[0]
    if bsz % n:
        raise ValueError(f"microbatch={n} does not divide the batch of "
                         f"{bsz}")
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero grad for every parameter that the loss did not reach, so
    that SGD still decays it and runs its momentum, as the JAX package's
    optax chain (add_decayed_weights -> trace) does for every leaf."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def sync_grads(optimizer: torch.optim.Optimizer) -> None:
    """Sum every parameter's gradient over the ranks (one flattened
    all-reduce; nothing in a world of one).  Run after fill_missing_grads,
    so that every rank sends the same tensors."""
    all_reduce_grads([p for group in optimizer.param_groups
                      for p in group["params"]])


def make_contrast_loss_fn(cfg: TrainConfig, model: torch.nn.Module
                          ) -> Callable[..., tuple]:
    """Build loss_fn(state, batch, generator=None) -> (loss, metrics,
    commit): one forward of the train step, with commit() the bank EMA
    update, to be called after the loss's backward (its graph holds the
    banks as they were).  Metrics are 0-d tensors, detached.  The model's
    forward is the span `forward`, the losses from its outputs `nce`
    (utils/spans.py)."""
    if cfg.modal in ("RGB", "CMC"):
        return _baseline_bank_loss_fn(cfg, model)
    if (cfg.modal != "RGBD2S" or cfg.mem not in ("bank", "bank+jointspri3d")
            or cfg.arch not in ("HRNet", "HRNetPN")):
        raise NotImplementedError(
            f"train step for modal={cfg.modal} mem={cfg.mem} arch={cfg.arch}")
    stage2 = cfg.mem == "bank+jointspri3d"
    if stage2 and not cfg.linear_feat_map:
        raise ValueError("mem='bank+jointspri3d' needs linear_feat_map: its "
                         "losses read the linear_merge maps")
    # remat: the HRNet model's forward recomputes in the backward under
    # remat_policy (the JAX step's jax.checkpoint); it has no effect on
    # HRNetPN, whose pn_remat the model itself carries
    hrnet_remat = cfg.remat and cfg.arch == "HRNet"
    if hrnet_remat:
        check_policy(cfg.remat_policy)

    def nce(state: TrainState, batch: Dict[str, torch.Tensor], out: dict,
            y: torch.Tensor, generator: Optional[torch.Generator]) -> tuple:
        """The six-way NCE against the banks, and stage 2's losses, from
        the model's outputs: (loss, metrics, commit)."""
        feats = torch.stack([out["feat1"], out["feat2"], out["feat3"]])
        use_depth = batch.get("use_depth") if cfg.modality_missing else None
        # stage 2 masks the six directions by use_depth only
        use_rgb = None if stage2 else batch.get("use_rgb")
        mode = nce_mode(cfg, state.banks.shape[1], "neg_idx" in batch)
        # the replicated bank update takes every rank's rows (feats is
        # (3, B, dim): its rows are along dim 1)
        all_feats = gather_rows(feats.transpose(0, 1)).transpose(0, 1)
        all_y = gather_rows(y)
        if mode == "counts":
            per_sample = cmc3_losses_counts(
                feats, state.banks, y, k=cfg.nce_k, temperature=cfg.nce_t,
                counts=batch.get("counts"), generator=generator)

            def commit() -> None:
                for i in range(state.banks.shape[0]):
                    update_memory(state.banks[i], all_feats[i], all_y,
                                  cfg.nce_m)
        else:
            if "counts" in batch:
                raise ValueError(f"NCE mode {mode!r} draws indices: pin them "
                                 "with neg_idx, not counts")
            logits, commit = cmc3_forward(
                state.banks, feats, y, all_feats, all_y, k=cfg.nce_k,
                temperature=cfg.nce_t, m=cfg.nce_m, generator=generator,
                neg_idx=batch.get("neg_idx"), mode=mode)
            per_sample = [per_sample_nce(lg) for lg in logits]
        losses, accs = masked_six_way(per_sample, use_depth=use_depth,
                                      use_rgb=use_rgb)
        loss = torch.stack(losses).sum()
        metrics: Dict[str, torch.Tensor] = {}
        if stage2:
            lm1, lm2 = out["linear_merge1"], out["linear_merge2"]
            sp_losses, sp_accs = soft_pri3d_loss(
                lm1, lm2, batch["depth_mask"],
                cfg.pri3d_num_samples_per_image, cfg.temperature,
                use_depth=use_depth, sample_ind=batch.get("pix_idx"),
                generator=generator)
            j_losses, j_accs = joints_pri3d_loss(
                lm1, lm2, out["fm3"], batch["joints2d"], batch["joints_vis"],
                cfg.temperature, use_depth=use_depth)
            ones = torch.ones_like(y)
            scl = _scl_grouped(
                lm1, lm2, batch["joints2d"],
                ones if use_depth is None else use_depth,
                ones if batch.get("use_rgb") is None else batch["use_rgb"],
                cfg.temperature, cfg.scl_groups)
            # unit weights (contrast_trainer.py:980)
            loss = loss + sum(sp_losses) + sum(j_losses) + scl
            values = (*sp_losses, *sp_accs, *j_losses, *j_accs, scl)
            metrics.update({k: v.detach()
                            for k, v in zip(STAGE2_METRICS, values)})
        for name, l, a in zip(_DIRECTIONS, losses, accs):
            metrics[f"nce_loss_{name}"] = l.detach()
            metrics[f"nce_acc_{name}"] = a.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics, commit

    def loss_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> tuple:
        with span("forward"):
            batch = device_normalize(batch)
            model.train()
            y = batch["index"].long()
            # NHWC -> NCHW: a view, channels_last in memory
            rgbd = batch["rgbd"].permute(0, 3, 1, 2)
            if cfg.arch == "HRNetPN":
                # the point-cloud branch needs the crop-tracked pixel
                # coords and the per-sample depth mean
                # (_train_mem_skeleton3d :557-561)
                out = model(rgbd, batch["skeleton"], batch["depth_mask"],
                            batch["grid_xy"], cfg.pn_ori_h, cfg.pn_ori_w,
                            batch["depth_mean"], generator=generator,
                            u=batch.get("pts_u"), return_fm=stage2)
            elif hrnet_remat:
                with recompute(cfg.remat_policy):
                    out = model(rgbd, batch["skeleton"], return_fm=stage2)
            else:
                out = model(rgbd, batch["skeleton"], return_fm=stage2)
        with span("nce"):
            return nce(state, batch, out, y, generator)

    return loss_fn


def _jigsaw_inputs(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]) -> dict:
    """The model's x_jig (B*9, C, h, w) and shuffle_ids (B*9,) from the
    batch's rgbd_jig: each image's patch order from jig_perm, else a
    uniform permutation of 9 a row of the global batch drawn from
    `generator` (this rank keeps its rows); shuffle_ids address the rows
    of x_jig, image-major, as the JAX step's perms + 9 * image."""
    xj = batch["rgbd_jig"]
    bsz = xj.shape[0]
    perms = batch.get("jig_perm")
    if perms is None:
        if generator is None:
            raise ValueError("jigsaw: pass jig_perm or a generator")
        rows = bsz * world_size()
        perms = torch.rand((rows, 9), generator=generator,
                           device=xj.device).argsort(dim=1)[my_rows(rows)]
    perms = perms.long()
    ids = perms + 9 * torch.arange(bsz, device=perms.device)[:, None]
    return {"x_jig": xj.reshape(-1, *xj.shape[2:]).permute(0, 3, 1, 2),
            "shuffle_ids": ids.reshape(-1)}


def _baseline_bank_loss_fn(cfg: TrainConfig, model: torch.nn.Module
                           ) -> Callable[..., tuple]:
    """loss_fn(state, batch, generator=None) -> (loss, metrics, commit) of
    the bank baselines, modal 'RGB' (InsDis; PIRL with jigsaw: RGBMem,
    mem_bank.py:55-90, one bank) and 'CMC' (CMCMem, mem_bank.py:109-154:
    two banks, cross-modal logits), the JAX step's branches
    (contrast_step.py:226-311).  The negatives are one (B, K+1) draw shared
    by every logit matrix (pinned by neg_idx); the logits are the dense
    scores + a gather unless cfg.bank_logits is 'gather' or n_data is
    above counts_max_n_data, where the bank rows are gathered.  With
    jigsaw the jig logits take the swapped arguments of the reference
    trainer (contrast_trainer.py:447-448: logits of f2_jig against bank 2,
    f1_jig against bank 1) and the loss is (1 - beta) times the instance
    terms + beta times the jig terms; the metrics are the raw losses.
    commit() writes the global batch's features into the banks."""
    if cfg.mem != "bank":
        raise NotImplementedError(f"modal {cfg.modal} with mem {cfg.mem}")
    cmc = cfg.modal == "CMC"

    def loss_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> tuple:
        model.train()
        y = batch["index"].long()
        kw = (_jigsaw_inputs(batch, generator)
              if cfg.jigsaw and "rgbd_jig" in batch else {})
        out = model(batch["rgbd"].permute(0, 3, 1, 2), **kw)
        banks = state.banks
        n_data = banks.shape[1]
        if "neg_idx" in batch:
            idx = batch["neg_idx"].long()
        else:
            if generator is None:
                raise ValueError("pass neg_idx or a generator")
            idx = sample_negative_indices(generator, y, n_data, cfg.nce_k)
        dense = ((cfg.dense_scores or cfg.bank_logits != "gather")
                 and n_data <= cfg.counts_max_n_data)

        def lg(x, bank_i):
            return memory_logits(x, banks[bank_i], idx, cfg.nce_t, dense)

        if cmc:
            feats = [out["feat1"], out["feat2"]]
            logits = [lg(out["feat1"], 1), lg(out["feat2"], 0)]
            names = ["12", "21"]
            if "feat1_jig" in out:
                logits += [lg(out["feat2_jig"], 1), lg(out["feat1_jig"], 0)]
                names += ["jig2", "jig1"]
        else:
            feats = [out["feat"]]
            logits = [lg(out["feat"], 0)]
            names = ["ins"]
            if "feat_jig" in out:
                logits.append(lg(out["feat_jig"], 0))
                names.append("jig")
        losses, accs = compute_loss_accuracy(logits)
        if len(names) > len(feats):  # the jig terms follow
            weights = [1 - cfg.beta] * len(feats) + [cfg.beta] * len(feats)
            loss = sum(w * l for w, l in zip(weights, losses))
        else:
            loss = sum(losses)
        all_y = gather_rows(y)
        all_feats = [gather_rows(f) for f in feats]

        def commit() -> None:
            for i, f in enumerate(all_feats):
                update_memory(banks[i], f, all_y, cfg.nce_m)

        metrics: Dict[str, torch.Tensor] = {}
        for name, l, a in zip(names, losses, accs):
            metrics[f"nce_loss_{name}"] = l.detach()
            metrics[f"nce_acc_{name}"] = a.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics, commit

    return loss_fn


def make_moco_train_step(cfg: TrainConfig, model: torch.nn.Module,
                         steps_per_epoch: int
                         ) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(state, batch, generator=None) -> metrics for mem='moco'
    (contrast_trainer.py `_train_moco`, :255-392; the JAX step's
    moco_loss_fn and moco_train_step).

    rgbd stacks the query crop and the key crop on channels.  The query
    pass runs the model (with the patch stack for jigsaw); the key pass
    runs state.key_model, whose parameters are the EMA ones, with BN in
    train mode (the reference's set_bn_train) and no gradient, on the key
    batch.  Its BN statistics update lands in the key encoder's own
    buffers, which are never read; the model's are untouched.  BN takes
    the global batch's statistics (F10), so ShuffleBN's permutation of the
    key batch would change only the order of a sum: the port makes no such
    draw and exchanges no rows, at any world size (ROADMAP.md Queue 3,
    F12).
    RGB (RGBMoCo, mem_moco.py:60-88): logits of the query against its key
    and the queue, loss (1 - beta) l + beta l_jig with jigsaw.  CMC
    (CMCMoCo, mem_moco.py:91-142): each modality's query against the
    other's key and queue, the jig terms with the swapped arguments
    (contrast_trainer.py:306-311).  After the backward the global batch's
    keys are enqueued in rank order, SGD steps, and the key encoder's
    parameters move to a e + (1 - a) p, a = cfg.alpha (momentum_update,
    contrast_trainer.py:1041-1045).  The metrics are the JAX step's."""
    if cfg.modal not in ("RGB", "CMC"):
        raise NotImplementedError(f"mem='moco' with modal {cfg.modal}")
    if max(cfg.microbatch, 1) > 1:
        raise ValueError("microbatch is not defined for mem='moco': the "
                         "JAX package's moco step takes the whole batch")
    lr_fn = learning_rate_fn(cfg, steps_per_epoch)
    cmc = cfg.modal == "CMC"

    def moco_loss(state: TrainState, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator]) -> tuple:
        model.train()
        state.key_model.train()
        x = batch["rgbd"].permute(0, 3, 1, 2)
        c = x.shape[1] // 2
        q_in, k_in = x[:, :c], x[:, c:]
        kw = (_jigsaw_inputs(batch, generator)
              if cfg.jigsaw and "rgbd_jig" in batch else {})
        out_q = model(q_in, **kw)
        with torch.no_grad():
            out_k = state.key_model(k_in)
        queues = state.moco.queues
        metrics: Dict[str, torch.Tensor] = {}
        if cmc:
            k1, k2 = out_k["feat1"], out_k["feat2"]
            l1, a1 = nce_loss_and_acc(moco_logits(out_q["feat1"], k2,
                                                  queues[1], cfg.nce_t))
            l2, a2 = nce_loss_and_acc(moco_logits(out_q["feat2"], k1,
                                                  queues[0], cfg.nce_t))
            loss = l1 + l2
            metrics.update(nce_acc_12=a1, nce_acc_21=a2)
            if "feat1_jig" in out_q:
                l1j, a1j = nce_loss_and_acc(moco_logits(
                    out_q["feat2_jig"], k2, queues[1], cfg.nce_t))
                l2j, a2j = nce_loss_and_acc(moco_logits(
                    out_q["feat1_jig"], k1, queues[0], cfg.nce_t))
                loss = (1 - cfg.beta) * loss + cfg.beta * (l1j + l2j)
                metrics.update(nce_acc_jig2=a1j, nce_acc_jig1=a2j,
                               loss_jig=0.5 * (l1j + l2j))
            keys = torch.stack([k1, k2])
        else:
            key = out_k["feat"]
            loss, acc = nce_loss_and_acc(moco_logits(out_q["feat"], key,
                                                     queues[0], cfg.nce_t))
            metrics["nce_acc"] = acc
            if "feat_jig" in out_q:
                lj, aj = nce_loss_and_acc(moco_logits(
                    out_q["feat_jig"], key, queues[0], cfg.nce_t))
                loss = (1 - cfg.beta) * loss + cfg.beta * lj
                metrics.update(nce_acc_jig=aj, loss_jig=lj)
            keys = key[None]
        metrics["loss"] = loss
        # the global batch's keys, rank order: (n_modal, B, dim), rows on
        # dim 1
        all_keys = gather_rows(keys.transpose(0, 1)).transpose(0, 1)
        return loss, {k: v.detach() for k, v in metrics.items()}, all_keys

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        lr = lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics, all_keys = moco_loss(state, batch, generator)
        loss.backward()
        # after the backward: the logits' graph holds the queue as it was
        moco_enqueue(state.moco, all_keys)
        fill_missing_grads(state.optimizer)
        sync_grads(state.optimizer)
        state.optimizer.step()
        a = cfg.alpha
        with torch.no_grad():
            for e, p in zip(state.key_model.parameters(),
                            model.parameters()):
                e.mul_(a).add_(p, alpha=1 - a)
        state.step += 1
        metrics = global_metrics(metrics)
        metrics["learning_rate"] = lr
        return metrics

    return train_step


def make_contrast_train_step(cfg: TrainConfig, model: torch.nn.Module,
                             steps_per_epoch: int
                             ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build step(state, batch, generator=None) -> metrics.

    The step updates `state` in place (params, optimizer, banks, step).
    `generator` draws, in this order: for HRNetPN the depth2pts uniforms
    unless the batch carries `pts_u`, the negatives unless it carries
    `counts` (the counts form) or `neg_idx` (the index form), and in
    stage 2 the soft-Pri3D pixels unless it carries `pix_idx`.
    The NCE's formulation is `nce_mode`'s.
    cfg.microbatch = n > 1 runs n forward/backward passes of batch/n
    samples against the same parameters (train_step_microbatch of the JAX
    package): the grads are averaged over n, BN running statistics and
    the banks chain through the microbatches (each sees the previous
    one's update), one optimizer step at the end, and each metric is the
    mean over the microbatches.  Under data parallelism `batch` holds this
    rank's rows (mesh.shard_rows with the same microbatch count, so its
    i-th chunk is its share of the global microbatch i) and `generator`
    is seeded alike on every rank.
    Metrics: nce_loss_*/nce_acc_* for the six directions, loss and
    learning_rate, and in stage 2 STAGE2_METRICS, as 0-d tensors
    (learning_rate a float).  The baselines' metrics are their branches'
    (_baseline_bank_loss_fn); mem='moco' is make_moco_train_step's.
    Spans (utils/spans.py; none under mem='moco'): the step is
    `train_step`, its global step attached; inside it each microbatch's
    `forward` and `nce` (HCMoCo's loss_fn; the bank baselines' is not
    split), `backward` and `bank_update`, then `optimizer` (the
    gradients' all-reduce as `grad_sync` inside it) and `metrics`.
    The model's HRNet encoders replay their forward and backward from
    CUDA graphs where the step runs one microbatch and
    train/graphs.py::engages holds (on the card, a world of one, no
    recompute): the same kernels, bit for bit, each forward replay a span
    `encoder_graph` inside `forward`."""
    if cfg.mem == "moco":
        return make_moco_train_step(cfg, model, steps_per_epoch)
    loss_fn = make_contrast_loss_fn(cfg, model)
    n_micro = max(cfg.microbatch, 1)
    lr_fn = learning_rate_fn(cfg, steps_per_epoch)
    if n_micro == 1:
        graphs.install(model)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]
             ) -> Dict[str, torch.Tensor]:
        parts = [batch] if n_micro == 1 else _split(batch, n_micro)
        lr = lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        per_part = []
        for part in parts:
            loss, metrics, commit = loss_fn(state, part, generator)
            with span("backward"):
                (loss / n_micro if n_micro > 1 else loss).backward()
            with span("bank_update"):
                commit()
            per_part.append(metrics)
        with span("optimizer"):
            fill_missing_grads(state.optimizer)
            with span("grad_sync"):
                sync_grads(state.optimizer)
            state.optimizer.step()
        state.step += 1
        with span("metrics"):
            per_part = [global_metrics(m) for m in per_part]
            if n_micro == 1:
                metrics = per_part[0]
            else:
                metrics = {k: torch.stack([m[k] for m in per_part]).mean()
                           for k in per_part[0]}
        metrics["learning_rate"] = lr
        return metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        with span("train_step", step=state.step):
            return step(state, batch, generator)

    return train_step
