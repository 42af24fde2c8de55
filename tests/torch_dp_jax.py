"""JAX-side helpers of the port's data-parallel tests: the JAX package's
mesh step as the reference, and the comparisons every case makes.

Tolerances (stated in each test module's docstring): TOL against JAX,
rtol 1e-4 / atol 1e-5 (the one-process step tests'); W1_TOL against the
port's own one-process run of the same math (torch_dp_worker.one_process:
BN with the ranks' E[x^2] - E[x]^2), rtol 1e-5 / atol 3e-6: f32
rounding (the two add their sums in another order), carried through a
step's update.
"""

import jax
import numpy as np
import torch

from hcmoco_tpu.parallel.mesh import replicated_sharding, shard_batch

from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict

from torch_parity_common import check_bn_stats

TOL = dict(rtol=1e-4, atol=1e-5)
W1_TOL = dict(rtol=1e-5, atol=3e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_steps(jstep, jstate, bs, mesh):
    """The JAX mesh step over the batches: its states (initial, then after
    each step) and metrics."""
    rep = replicated_sharding(mesh)
    states, metrics = [jax.device_put(jstate, rep)], []
    for i, b in enumerate(bs):
        s, m = jstep(states[-1], shard_batch(b, mesh), jax.random.PRNGKey(i))
        states.append(s)
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def assert_ranks_equal(a, b):
    """Two ranks' results equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_ranks_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert_ranks_equal(u, v)
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol,
                               err_msg=what)


def check_steps(label, ranks, one, jstates, jmetrics, metric_names, model,
                rows, start, convert=flax_to_port_state_dict,
                key="model", params_of=lambda p: p, stats_of=lambda s: s,
                updates=1, jax_param_steps=None):
    """Two ranks' results of one case against each other (bit for bit),
    the port's one-process run and JAX's mesh step, after each step:
    metrics, banks, parameters and (with `rows`, the BN layers' rows of
    the global batch) BN running statistics.  `key` picks the module's
    state dicts in the results ('model' or 'classifier'), params_of /
    stats_of its subtree of JAX's params and batch stats, convert maps
    those to the port's state dict, `model` is a port module to load the
    states into and `start` its state dict before step 1; `updates` BN
    updates a step (one a microbatch).  jax_param_steps: hold the
    parameters and BN statistics to JAX's after the first that many steps
    only (all by default); the one-process run holds them after every
    step."""
    r0, r1 = ranks
    assert_ranks_equal(r0, r1)
    before = start
    n_jax = len(jmetrics) if jax_param_steps is None else jax_param_steps
    for s in range(len(jmetrics)):
        where = f"{label} step {s}"
        for k in metric_names:
            close(r0["metrics"][s][k], jmetrics[s][k], TOL, f"{where} {k}")
            close(r0["metrics"][s][k], one["metrics"][s][k], W1_TOL,
                  f"{where} {k} vs one process")
        close(r0["banks"][s], jstates[s + 1].memory.banks, TOL,
              f"{where} banks")
        close(r0["banks"][s], one["banks"][s], W1_TOL,
              f"{where} banks vs one process")
        js = jstates[s + 1]
        want = convert(params_of(js.params), stats_of(js.batch_stats))
        got = r0[key][s]
        for k, v in got.items():
            if v.is_floating_point():
                close(v, one[key][s][k], W1_TOL,
                      f"{where} {k} vs one process")
        if s >= n_jax:
            before = got
            continue
        for k, _ in model.named_parameters():
            close(got[k], want[k], TOL, f"{where} {k}")
        if rows is not None:
            model.load_state_dict(got)
            assert check_bn_stats(
                model, before, params_of(js.params),
                stats_of(jstates[s].batch_stats), stats_of(js.batch_stats),
                rows, convert=convert, updates=updates, **TOL) == len(rows)
        before = got
