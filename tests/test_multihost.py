"""Multi-host runtime test: two REAL processes over the DCN control plane.

SURVEY.md §5 "distributed communication backend": the reference has none
(single-process mutexes); here `jax.distributed` + a global mesh is the
host-level story. This test spawns two localhost processes (2 virtual CPU
devices each), initializes the cross-process runtime through
parallel.multihost, and runs a shard_map psum over the 4-device GLOBAL
mesh — the exact communication pattern of the distributed Schur reduction
(parallel/sharded_ba.py), with the inter-process legs standing in for DCN.
"""

import socket
import subprocess
import sys

WORKER = r"""
import os, sys
rank, port = int(sys.argv[1]), sys.argv[2]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[3])
from monoorbslam3_tpu.parallel import multihost

assert multihost.initialize(coordinator=f"localhost:{port}",
                            num_processes=2, process_id=rank)
info = multihost.process_info()
assert info["process_count"] == 2, info
assert info["global_devices"] == 4, info
assert info["local_devices"] == 2, info

import numpy as np
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

mesh = multihost.global_mesh(("dp",))
assert mesh.devices.size == 4

# the sharded-BA reduction pattern: per-shard partial sums, one psum
def local(x):
    return jax.lax.psum(jnp.sum(x), "dp")

fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("dp"),),
                       out_specs=P()))
x = jnp.arange(8.0)
sharding = NamedSharding(mesh, P("dp"))
x = jax.device_put(x, sharding)
out = fn(x)
assert float(out) == 28.0, float(out)
print(f"WORKER_OK {rank}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_global_mesh_psum(tmp_path):
    port = _free_port()
    repo = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(rank), str(port), repo],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            # a clean env: the parent test process pins 8 virtual devices
            # via conftest XLA_FLAGS, which the worker overrides to 2
            env={k: v for k, v in __import__("os").environ.items()
                 if k != "XLA_FLAGS"},
        )
        for rank in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"WORKER_OK {rank}" in out, out


def test_single_process_initialize_is_noop():
    from monoorbslam3_tpu.parallel import multihost

    assert multihost.initialize() is False


def test_global_mesh_shape_layout():
    """Host-major layout: with (dp, mp) axes the fast axis stays local."""
    import jax

    from monoorbslam3_tpu.parallel import multihost

    n = len(jax.devices())
    if n < 4:
        import pytest

        pytest.skip("needs >= 4 virtual devices")
    mesh = multihost.global_mesh(("dp", "mp"), shape=(2, 2))
    assert mesh.shape == {"dp": 2, "mp": 2}
    # fastest-varying axis (mp) holds adjacent device ids (same host)
    ids = [[d.id for d in row] for row in mesh.devices]
    assert ids[0][1] == ids[0][0] + 1
