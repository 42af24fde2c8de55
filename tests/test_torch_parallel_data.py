"""Data parallelism's host side and entry points, on the CPU.

* Row sharding of the host pipeline: each rank's DataSource decodes only
  its rows of the global batch (the other rows' random draws consumed
  without a decode, `skip_draws`), and the ranks' batches put back in
  row order are the one-process batch bit for bit, one decode thread,
  with and without microbatches: the synthetic source, the on-disk
  NTU + MPII fixture (NTUMPIIGCN), the NTU + Parsing-4K one
  (NTUSegJoint), and a pack (through NTUMPIIGCN and through the slot
  writer).
* The CLIs under torchrun's environment on two gloo ranks (`--multihost
  --device cpu`), and the pre-training CLI under a SLURM job step's
  (the same states, checkpoint and metrics as under torchrun, bit for
  bit): a 2-step pre-training run writes one checkpoint (rank
  0), its ranks end equal bit for bit; resuming it on two ranks and in
  one process (BN with the ranks' variance formula,
  torch_dp_common.ranks_formula) restores the saved state bit for
  bit on every rank, and the two resumed runs end within rtol 1e-4,
  atol 1e-5 of each other after one more step (the JAX tolerance: the
  CLI's synthetic source has all-zero depth samples, which leave the
  tiny depth encoder ill-conditioned, as tests/test_torch_train_step.py
  notes, and part the two f32 reduction orders by more than f32
  rounding).  The segmentor CLI's 2-step run, and the global batch's
  divisibility error.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from hcmoco_tpu_torch.cli import main_contrast as cli
from hcmoco_tpu_torch.data import combined, pipeline
from hcmoco_tpu_torch.data.fixtures import (make_mpii_fixture,
                                            make_ntu_fixture,
                                            make_seg_fixture)
from hcmoco_tpu_torch.data.ntu import NTURGBDPairs
from hcmoco_tpu_torch.data.packed import PackedNTUSkeleton, pack_ntu
from hcmoco_tpu_torch.data.synthetic import SyntheticContrastSource
from hcmoco_tpu_torch.parallel.mesh import shard_positions

from torch_dp_common import ranks_formula, ranks_running, run_ranks

torch.set_num_threads(1)

SIZE, BSZ, BATCHES = 32, 8, 3


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trees")
    ntu, ntu_list = make_ntu_fixture(str(root / "ntu"), n_frames=6)
    mpii = make_mpii_fixture(str(root / "mpii"), n_images=3)
    seg, seg_list = make_seg_fixture(str(root / "seg"), ntu, n_frames=3)
    pack = str(root / "pack")
    pack_ntu(ntu, ntu_list, pack)
    return dict(ntu=ntu, ntu_list=ntu_list, mpii=mpii, seg=seg,
                seg_list=seg_list, pack=pack)


def _dataset(trees, kind):
    kw = dict(size=SIZE, random_flip=True, random_resized_crop=True, seed=1)
    if kind == "ntu_mpii":
        return combined.NTUMPIIGCN(trees["ntu"], trees["ntu_list"],
                                   trees["mpii"], "train", **kw)
    if kind == "ntu_mpii_grid":
        return combined.NTUMPIIGCN(trees["ntu"], trees["ntu_list"],
                                   trees["mpii"], "train", with_grid=True,
                                   **kw)
    if kind == "ntu_seg":
        kw["random_flip"] = False
        return combined.NTUSegJoint(trees["ntu"], trees["ntu_list"],
                                    trees["seg"], trees["seg_list"], **kw)
    if kind == "pack_mpii":
        return combined.NTUMPIIGCN(
            trees["ntu"], trees["ntu_list"], trees["mpii"], "train",
            ntu_dataset=PackedNTUSkeleton(trees["pack"], **kw), **kw)
    assert kind == "pack_slots"
    return PackedNTUSkeleton(trees["pack"], raw_output=True, **kw)


def _batches(it, n):
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _assemble(per_rank, rows):
    """The ranks' batches written back to their rows of the global batch."""
    out = {}
    for b, pos in zip(per_rank, rows):
        for k, v in b.items():
            if k not in out:
                out[k] = np.zeros((BSZ,) + v.shape[1:], v.dtype)
            out[k][pos] = v
    return out


def _check_sharded(make_source, micro):
    """make_source(rows) -> an iterable of batches; rows None: the one
    process's."""
    want = _batches(iter(make_source(None)), BATCHES)
    rows = [shard_positions(BSZ, r, 2, micro) for r in range(2)]
    got = [_batches(iter(make_source(r)), BATCHES) for r in rows]
    for i in range(BATCHES):
        per_rank = [g[i] for g in got]
        for b, r in zip(per_rank, rows):
            assert all(v.shape[0] == len(r) for v in b.values())
        whole = _assemble(per_rank, rows)
        assert set(whole) == set(want[i])
        for k, v in want[i].items():
            assert whole[k].dtype == v.dtype, k
            np.testing.assert_array_equal(whole[k], v, err_msg=f"{i} {k}")


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("kind", ["ntu_mpii", "ntu_mpii_grid", "ntu_seg",
                                  "pack_mpii", "pack_slots"])
def test_ranks_decode_their_rows_of_the_global_batch(trees, kind, micro):
    def make(rows):
        ds = _dataset(trees, kind)
        w = (np.ones(len(ds)) if kind == "pack_slots" else
             pipeline.mixing_weights(len(ds), ds.aux_len,
                                     len(ds) - ds.aux_len))
        return pipeline.DataSource(ds, BSZ, w, seed=2, num_workers=1,
                                   rows=rows)

    _check_sharded(make, micro)


def test_skipped_rows_are_not_decoded(trees):
    """Rank 1 of 2 decodes rows 4-7 of a global batch; rows 0-3 take
    skip_draws, in global order (one decode thread: the jobs run in the
    order they were submitted)."""
    ds = _dataset(trees, "ntu_mpii")
    calls = []
    get, skip = ds.__getitem__, ds.skip_draws

    class Counted:
        aux_len = ds.aux_len

        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            calls.append(("get", i))
            return get(i)

        def skip_draws(self, i):
            calls.append(("skip", i))
            return skip(i)

    weights = np.ones(len(ds))
    idx = pipeline.WeightedBatchSampler(weights, seed=2).draw(BSZ)
    src = pipeline.DataSource(Counted(), BSZ, weights, seed=2,
                              num_workers=1, prefetch=1,
                              rows=shard_positions(BSZ, 1, 2))
    (batch,) = _batches(iter(src), 1)
    want = ([("skip", int(i)) for i in idx[:BSZ // 2]]
            + [("get", int(i)) for i in idx[BSZ // 2:]])
    assert calls[:BSZ] == want
    assert batch["index"].tolist() == idx[BSZ // 2:].tolist()


def test_synthetic_source_shards(trees):
    def make(rows):
        return cli.shard_stream(iter(SyntheticContrastSource(
            BSZ, size=SIZE, n_data=64, seed=3)), rows)

    _check_sharded(make, 1)
    _check_sharded(make, 2)


def test_unsharded_dataset_refuses_rows(trees):
    ds = NTURGBDPairs(trees["ntu"], trees["ntu_list"], size=SIZE)
    with pytest.raises(NotImplementedError, match="skip_draws"):
        pipeline.DataSource(ds, BSZ, np.ones(len(ds)), rows=[0, 1])
    # every row is a one-process source
    pipeline.DataSource(ds, 2, np.ones(len(ds)), rows=[0, 1])


def test_decode_threads_split_over_the_host(monkeypatch):
    args = cli.build_argparser().parse_args(["--num_workers", "8"])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert cli.decode_threads(args, 1) == 8
    assert cli.decode_threads(args, 4) == 2
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "16")
    assert cli.decode_threads(args, 16) == 1


TINY = ["--device", "cpu", "--synthetic", "32", "--width", "4",
        "--crop_size", "32", "--batch_size", str(BSZ), "--nce_k", "15",
        "--compute_dtype", "float32", "--print_freq", "1", "--seed", "0"]


def _states_equal(a, b):
    assert a["step"] == b["step"]
    assert torch.equal(a["banks"], b["banks"])
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One pair of ranks runs the pre-training CLI for 2 steps, then the
    segmentor CLI for 2; their save directories and results by CLI."""
    tmp = tmp_path_factory.mktemp("clis")
    save, seg = str(tmp / "save"), str(tmp / "seg")
    argv = TINY + ["--recipe", "first_stage/ntumpiirgbd2s_hrnet_w18",
                   "--model_path", save, "--multihost"]
    ranks = run_ranks(None, str(tmp), clis=[
        ("contrast", argv + ["--epochs", "1", "--max_steps", "2"]),
        ("segmentor", TINY + ["--model_path", seg, "--multihost",
                              "--epochs", "1", "--max_steps", "2"])])
    return dict(tmp=tmp, argv=argv, save=save, seg=seg,
                contrast=[r[0] for r in ranks],
                segmentor=[r[1] for r in ranks])


def test_multihost_cli_checkpoint_and_resume(cli_runs):
    """Two ranks train 2 steps and write one checkpoint; a resume on two
    ranks and one in this process restore it bit for bit, and end within
    the JAX tolerance of each other after 1 more step."""
    tmp, argv, save = cli_runs["tmp"], cli_runs["argv"], cli_runs["save"]
    first = cli_runs["contrast"]
    _states_equal(first[0]["ready"], first[1]["ready"])
    _states_equal(first[0]["end"], first[1]["end"])
    assert first[0]["steps"] == first[1]["steps"] == 2
    (run_dir,) = os.listdir(save)
    run_dir = os.path.join(save, run_dir)
    files = sorted(os.listdir(run_dir))
    assert [f for f in files if f.endswith(".pt")] == ["epoch_1.pt"]
    ckpt = torch.load(os.path.join(run_dir, "epoch_1.pt"), weights_only=True)
    saved = {"model": ckpt["model"], "banks": ckpt["banks"],
             "step": ckpt["step"]}
    _states_equal(saved, first[0]["end"])
    with open(os.path.join(run_dir, "metrics.tsv")) as f:
        assert len(f.read().splitlines()) == 2  # rank 0's header + epoch 1

    one_dir = str(tmp / "one")
    shutil.copytree(save, one_dir)
    more = ["--epochs", "2", "--resume", "auto", "--max_steps", "3"]
    seen = {}
    os.makedirs(tmp / "resume")
    # the one-process resume runs while the ranks resume theirs
    with ranks_running(None, str(tmp / "resume"),
                       clis=[("contrast", argv + more)]) as ranks:
        with ranks_formula():
            one = cli.main([a if a != save else one_dir for a in argv
                            if a != "--multihost"] + more,
                           on_ready=lambda st: seen.update(
                               step=st.step, banks=st.banks.clone(),
                               model={k: v.clone() for k, v in
                                      st.model.state_dict().items()}))
        resumed = [r[0] for r in ranks()]
    for r in resumed:
        _states_equal(r["ready"], saved)
    _states_equal(resumed[0]["end"], resumed[1]["end"])
    _states_equal(seen, saved)
    end = resumed[0]["end"]
    assert one.state.step == end["step"] == 3
    np.testing.assert_allclose(one.state.banks.numpy(), end["banks"].numpy(),
                               rtol=1e-4, atol=1e-5)
    for k, v in one.state.model.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), end["model"][k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_multihost_cli_under_slurm(cli_runs, tmp_path):
    """The same 2-step pre-training run on two ranks launched with a
    SLURM job step's variables and none of torchrun's: each joins as
    rank SLURM_PROCID of SLURM_NTASKS at the node list's first host and
    SLURM_JOB_ID's port, and the run ends where the torchrun run did:
    the same states, checkpoint and metrics, bit for bit."""
    save = str(tmp_path / "save")
    argv = [a if a != cli_runs["save"] else save for a in cli_runs["argv"]]
    ranks = run_ranks(None, str(tmp_path), clis=[
        ("contrast", argv + ["--epochs", "1", "--max_steps", "2"])],
        launcher="slurm")
    runs = [r[0] for r in ranks]
    for r, run in enumerate(runs):
        joined = run["joined"]
        assert (joined["launcher"], joined["rank"], joined["world"]) == (
            "slurm", r, 2)
        assert joined["address"].startswith("localhost:")
        assert int(joined["address"].split(":")[1]) >= 61440
    assert runs[0]["joined"]["address"] == runs[1]["joined"]["address"]
    torchrun = cli_runs["contrast"][0]
    for run in runs:
        assert run["steps"] == 2
        _states_equal(run["ready"], torchrun["ready"])
        _states_equal(run["end"], torchrun["end"])
    files = []
    for root in (save, cli_runs["save"]):
        (run_dir,) = os.listdir(root)
        run_dir = os.path.join(root, run_dir)
        ckpt = torch.load(os.path.join(run_dir, "epoch_1.pt"),
                          weights_only=True)
        with open(os.path.join(run_dir, "metrics.tsv")) as f:
            epoch1 = f.read().splitlines()[:2]  # header and epoch 1
        files.append(({"model": ckpt["model"], "banks": ckpt["banks"],
                       "step": ckpt["step"]}, epoch1))
    _states_equal(files[0][0], files[1][0])
    assert files[0][1] == files[1][1]


def test_multihost_segmentor_cli(cli_runs):
    """The segmentor CLI on two ranks: 2 steps, ranks equal, one
    checkpoint."""
    save, res = cli_runs["seg"], cli_runs["segmentor"]
    _states_equal(res[0]["end"], res[1]["end"])
    assert res[0]["steps"] == 2
    (run_dir,) = os.listdir(save)
    assert [f for f in os.listdir(os.path.join(save, run_dir))
            if f.endswith(".pt")] == ["epoch_1.pt"]


def test_global_batch_must_split_over_the_ranks(tmp_path, monkeypatch):
    """The JAX CLI's error when --batch_size does not split over the
    ranks (the process group faked as rank 0 of 2: the check runs before
    any collective)."""
    from hcmoco_tpu_torch.parallel import mesh

    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh, "init_distributed", lambda **kw: (0, 2))
    with pytest.raises(SystemExit, match="must be divisible by the "
                       "2-device 'data' mesh axis"):
        cli.main([a if a != str(BSZ) else "7" for a in TINY]
                 + ["--model_path", str(tmp_path / "x"), "--multihost"])
