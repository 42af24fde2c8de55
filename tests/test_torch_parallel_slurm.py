"""`--multihost` from a SLURM job step's environment
(hcmoco_tpu_torch/parallel/mesh.py::cluster_env), held to the JAX
package's way in: jax.distributed.initialize() finds a SLURM cluster
through jax._src.clusters.slurm_cluster.SlurmCluster, whose coordinator is
the first host of SLURM_STEP_NODELIST on port SLURM_JOB_ID % 4096 + 61440
and whose process is SLURM_PROCID of SLURM_NTASKS.  The port reads the
same variables, in JAX's four node-list formats, with torchrun's
environment first where it is set; local_world_size reads
SLURM_STEP_TASKS_PER_NODE where torchrun's LOCAL_WORLD_SIZE is absent.
Two gloo ranks under these variables alone are
tests/test_torch_parallel_data.py::test_multihost_cli_under_slurm.
"""

import pytest
from jax._src.clusters.slurm_cluster import SlurmCluster

from hcmoco_tpu_torch.parallel import mesh

NODE_LISTS = ["node001", "node001,host2", "node[001-0015],host2",
              "node[001,007-015],host2"]


def _slurm(monkeypatch, **kw):
    for k in mesh.TORCHRUN_ENV + mesh.SLURM_ENV + (
            "LOCAL_WORLD_SIZE", "SLURM_STEP_TASKS_PER_NODE", "SLURM_NODEID"):
        monkeypatch.delenv(k, raising=False)
    env = dict(SLURM_JOB_ID="123457", SLURM_NTASKS="8", SLURM_PROCID="5",
               SLURM_LOCALID="1")
    env.update(kw)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("node_list", NODE_LISTS)
def test_slurm_coordinator_matches_jax(node_list, monkeypatch):
    _slurm(monkeypatch, SLURM_STEP_NODELIST=node_list)
    assert SlurmCluster.is_env_present()
    got = mesh.cluster_env()
    assert got["launcher"] == "slurm"
    assert f"{got['addr']}:{got['port']}" == \
        SlurmCluster.get_coordinator_address(None, None) == "node001:62017"
    assert (got["rank"], got["world"], got["local_rank"]) == (
        SlurmCluster.get_process_id(), SlurmCluster.get_process_count(),
        SlurmCluster.get_local_process_id())
    # MASTER_PORT overrides the job id's port, as JAX's port override does
    monkeypatch.setenv("MASTER_PORT", "29500")
    got = mesh.cluster_env()
    assert f"{got['addr']}:{got['port']}" == \
        SlurmCluster.get_coordinator_address(None, "29500")
    # torchrun's environment wins where it is set
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert mesh.cluster_env()["launcher"] == "torchrun"


@pytest.mark.parametrize("tasks,node,want", [("4(x2)", "1", 4),
                                             ("2,1", "1", 1)])
def test_local_world_size_from_slurm(tasks, node, want, monkeypatch):
    _slurm(monkeypatch, SLURM_STEP_NODELIST="node[001-002]",
           SLURM_STEP_TASKS_PER_NODE=tasks, SLURM_NODEID=node)
    assert mesh.local_world_size() == want
    monkeypatch.setenv("SLURM_NODEID", "0")
    assert mesh.local_world_size() == (4 if tasks == "4(x2)" else 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")  # torchrun's wins
    assert mesh.local_world_size() == 3


def test_slurm_world_of_one_joins_and_leaves(monkeypatch, tmp_path):
    """--multihost in a one-task SLURM step: the CLI joins a gloo group of
    one at the port SLURM_JOB_ID gives, trains, and leaves the group."""
    import torch.distributed as dist

    from hcmoco_tpu_torch.cli import main_contrast as cli
    from torch_dp_common import SLURM_PORT0, free_slurm_port

    port = free_slurm_port()
    _slurm(monkeypatch, SLURM_STEP_NODELIST="localhost", SLURM_NTASKS="1",
           SLURM_PROCID="0", SLURM_LOCALID="0",
           SLURM_JOB_ID=str(port - SLURM_PORT0))
    seen = {}
    run = cli.main(["--device", "cpu", "--synthetic", "8", "--recipe",
                    "first_stage/ntumpiirgbd2s_hrnet_w18", "--width", "4",
                    "--crop_size", "32", "--batch_size", "4", "--nce_k", "7",
                    "--compute_dtype", "float32", "--max_steps", "1",
                    "--model_path", str(tmp_path), "--multihost"],
                   on_ready=lambda st: seen.update(
                       mesh.JOINED, backend=dist.get_backend()))
    assert len(run.step_s) == 1
    assert seen == {"launcher": "slurm", "rank": 0, "world": 1,
                    "local_rank": 0, "address": f"localhost:{port}",
                    "backend": "gloo"}
    assert not dist.is_initialized() and not mesh.JOINED
