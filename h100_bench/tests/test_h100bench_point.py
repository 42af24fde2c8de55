"""Tests of the point-cloud cell `hrnetpn_w18_s1.p4096_b64` and its three
readers, on the CPU: the cell found by name with its metrics and limits,
the point work's bound enumerated level by level against roofline.py's
formulas, the name match of the port's point kernels, and each reader's
None where it finds nothing to read.  On the card (`-m cuda`): the
float8 control and the half-batch fault fail the cell's limits at its
own size.

    python -m pytest -m cuda h100_bench/tests/test_h100bench_point.py
"""

import json
import re
import sys

import pytest

import hcmoco_tpu_torch.utils

from h100bench_common import REPO

from h100_bench import cells, checks, control, points, roofline
from h100_bench.context import Context
from h100_bench.devtrace import Trace
from hcmoco_tpu_torch.utils import spans

CELL = "hrnetpn_w18_s1.p4096_b64"
NEW = ("point_fwd_ms", "point_ms", "point_roofline")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_the_cell_loads_with_its_metrics_and_limits():
    """Catches a cell that lost a file, or a metric that does not list
    it.  Its limits are hrnet_w18_s1.b224's but grad_gap's, 0.045: on
    the H100 the program read at most 0.0311 on fifteen seeds and the
    float8 control at least 0.0530 on ten (PERF.md), where cell 1's
    0.08 let the control pass every limit on one of them."""
    cell = cells.load_cell(REPO, CELL)
    assert cell.chips == 1
    run = cell.run
    assert (run["arch"], run["batch_size"], run["pn_num_points"],
            run["compute_dtype"]) == ("HRNetPN", 64, 4096, "bfloat16")
    assert {m["name"] for m in cell.end_to_end} == {
        "samples_per_s", "peak_mem_gib", "setup_s"}
    got = {m["name"] for m in cell.per_layer}
    assert got == {"device_idle_share", "step_mfu", "convbn_roofline",
                   "conv_ms", "bn_cast_ms", "launches_per_step",
                   "forward_ms", "backward_ms", "nce_bank_ms",
                   "optimizer_ms", *NEW}
    for name in NEW:
        assert callable(cells.reader(REPO, name))
    cell1 = cells.load_cell(REPO, "hrnet_w18_s1.b224").limits
    assert cell.limits == dict(cell1, grad_gap={"limit": 0.045})
    assert set(cell.limits) == set(checks.NAMES)


def test_point_bound_is_the_formulas_level_by_level():
    """points.step_s at the cell's shapes (64 clouds of 4096 points, bf16)
    against the formulas written out: a level or scale left out, a K5
    counted at another width, or FPS counted at SA0 fails here."""
    b, e = 64, 2
    k2, k3, k4, k5, k6 = (roofline.k2_s, roofline.k3_s, roofline.k4_s,
                          roofline.k5_s, roofline.k6_s)
    want = 0.0
    # SA0: 4096 points, every point a center (no FPS), no features
    for s in (16, 32):
        want += k3(b, 4096, 4096, s) + k5(b, 4096, 4096, s, 4, 4)[0]
    # SA1: 4096 -> 1024 centers; layer 0 widths 64 and 64
    want += k2(b, 4096, 1024)
    for s, f0 in ((16, 64), (32, 64)):
        want += (k3(b, 4096, 1024, s) + k5(b, 4096, 1024, s, 4, 4)[0]
                 + sum(k5(b, 4096, 1024, s, f0, e)))
    # SA2: 1024 -> 256; widths 128 and 128
    want += k2(b, 1024, 256)
    for s, f0 in ((16, 128), (32, 128)):
        want += (k3(b, 1024, 256, s) + k5(b, 1024, 256, s, 4, 4)[0]
                 + sum(k5(b, 1024, 256, s, f0, e)))
    # SA3: 256 -> 64; widths 256 and 256
    want += k2(b, 256, 64)
    for s, f0 in ((16, 256), (32, 256)):
        want += (k3(b, 256, 64, s) + k5(b, 256, 64, s, 4, 4)[0]
                 + sum(k5(b, 256, 64, s, f0, e)))
    # FP3..FP0: (unknown, known, known features' width)
    for n, m, c in ((256, 64, 1024), (1024, 256, 512), (4096, 1024, 512),
                    (4096, 4096, 256)):
        want += k4(b, n, m) + sum(k6(b, n, m, c, e))
    run = cells.load_cell(REPO, CELL).run
    assert points.step_s(run, run["batch_size"]) == pytest.approx(
        want, rel=1e-12)


def _kernels(path):
    """The names of a CUDA source's __global__ functions (each ends in
    `_kernel` in the port's sources)."""
    return {re.search(r"(\w+_kernel)\s*\(", part).group(1)
            for part in path.read_text().split("__global__")[1:]}


# kernel names of hrnet_w18_s1.b224's breakdown (ledger) and of the
# cuDNN, cuBLAS and PyTorch kernels a step launches
OTHERS = [
    "void_nhwcAddPaddingKernel___nv_bfloat16____nv_bfloat16__float__t",
    "_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvo",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop>",
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDA>",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "void at::native::(anonymous namespace)::upsample_bilinear2d_backward",
    "void at::native::index_elementwise_kernel<128, 4>",
    "void at::native::_scatter_gather_elementwise_kernel<128, 4>",
    "void at::native::reduce_kernel<512, 1>",
    "void cub::DeviceRadixSortOnesweepKernel<>",
    "Memset (Device)", "Memcpy DtoD (Device -> Device)",
]


def test_point_ms_takes_every_point_kernel_and_no_other():
    """Every __global__ kernel of the port's point sources matches, in
    the forms a trace may name it; K1/K1b and the BN-site kernels
    (csrc/matmul_bn.cu) and cell 1's top kernels do not."""
    csrc = REPO / "hcmoco_tpu_torch" / "csrc"
    mine = set()
    for f in ("fps.cu", "ball_query.cu", "three_nn.cu", "point_gather.cu"):
        mine |= _kernels(csrc / f)
    assert {"fps_kernel", "ball_query_kernel", "three_nn_kernel",
            "group_fwd_kernel", "interp_fwd_kernel"} <= mine
    assert any(k.startswith("csr_") for k in mine)
    assert any(k.startswith("segsum_") for k in mine)
    for k in mine:
        for name in (f"{k}(float const*, int)",
                     f"void {k}<__nv_bfloat16, 8>(Vec<__nv_bfloat16, 8>)",
                     f"void (anonymous namespace)::{k}<float, 4>(int)",
                     f"_Z{len(k)}{k}PKfi"):
            assert points.is_point_kernel(name), name
    other = _kernels(csrc / "matmul_bn.cu")
    assert other
    for name in sorted(other) + OTHERS:
        assert not points.is_point_kernel(f"void {name}(int)"), name


def _ctx(steps=2, traced=True, ops=()):
    run = cells.load_cell(REPO, CELL).run
    return Context(trace=Trace(ops=list(ops), window_s=1.0)
                   if traced else None, steps=steps, samples=64 * steps,
                   window_s=1.0, rows=64, run=run,
                   forward_flops=lambda: 0)


def test_readers_of_the_point_kernels():
    """point_ms sums the point kernels' device time a step and leaves
    others out; point_roofline is the bound over that time."""
    ops = [("fps_kernel(float const*)", 0, 2_000_000),
           ("void segsum_long_kernel<float, 4, true>(int)", 5, 3_000_000),
           ("void mm_bn_kernel<64>(int)", 9, 7_000_000)]
    ctx = _ctx(steps=2, ops=ops)
    assert cells.reader(REPO, "point_ms")(ctx) == pytest.approx(2.5)
    least = points.step_s(ctx.run, 64) * 2
    assert cells.reader(REPO, "point_roofline")(ctx) == pytest.approx(
        100 * least / 5e-3)


@pytest.mark.parametrize("metric", NEW)
def test_the_readers_read_none_without_a_trace(monkeypatch, metric):
    """No traced window, a window with no point kernel, or a program
    without the recorder or its point spans (the parent's): None."""
    read = cells.reader(REPO, metric)
    assert read(_ctx(traced=False)) is None
    spans.clear()
    assert read(_ctx(ops=[("void mm_bn_kernel<64>(int)", 0, 10)])) is None
    monkeypatch.setattr(spans, "recorded", lambda: [
        spans.Span("forward", None, 0, t0=0, t1=1, dev0=0, dev1=10)])
    assert read(_ctx(ops=[("void mm_bn_kernel<64>(int)", 0, 10)])) is None
    monkeypatch.delattr(hcmoco_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "hcmoco_tpu_torch.utils.spans", None)
    assert read(_ctx(ops=[("void mm_bn_kernel<64>(int)", 0, 10)])) is None


def test_point_fwd_ms_sums_the_point_spans_a_step(monkeypatch):
    """depth2pts, pn_sa and pn_fp inside forward, 1, 2 and 3 ms a step
    (the forward span itself and pts2depth are not counted)."""
    recs = []
    for i in range(2):
        root = spans.Span("forward", None, i, t0=0, t1=1, dev0=0,
                          dev1=10 ** 8)
        recs.append(root)
        for j, name in enumerate(["depth2pts", "pn_sa", "pn_fp",
                                  "pts2depth"]):
            recs.append(spans.Span(name, root, i, t0=0, t1=1, dev0=0,
                                   dev1=(j + 1) * 10 ** 6))
    monkeypatch.setattr(spans, "recorded", lambda: recs)
    assert cells.reader(REPO, "point_fwd_ms")(_ctx(steps=2)) == \
        pytest.approx(6.0)


def test_benchmark_json_adds_the_cell_by_appending():
    """The new cell's entries stand last in their lists, and every list
    that names it ends with it."""
    assert BENCH["workloads"][-1]["name"] == CELL
    assert BENCH["configs"][-1]["name"] == "hrnetpn_w18_s1"
    assert [m["name"] for m in BENCH["per_layer"][-3:]] == list(NEW)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if CELL in m.get("workloads", ()):
            assert m["workloads"][-1] == CELL


@pytest.mark.cuda
def test_control_and_fault_fail_at_the_cells_size():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = cells.load_cell(REPO, CELL).limits
    for variant, gaps in control.readings(CELL, 2 ** 31 + 99,
                                          torch.device("cuda", 0)):
        held = {k: v for k, (v, _) in gaps.items()
                if limits[k]["limit"] is not None}
        assert any(v > limits[k]["limit"] for k, v in held.items()), \
            (variant, gaps)
