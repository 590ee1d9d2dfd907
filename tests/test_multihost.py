"""Multi-host execution: a REAL 2-process jax.distributed CPU cluster.

The SPMD design (parallel/spmd.py) scales to several hosts, where
``jax.distributed.initialize`` builds the global device mesh and XLA routes
collectives between hosts.  No cluster is available in CI, but the *code
path* is executable on CPU: two subprocesses form a cluster (coordinator on
localhost), each contributes 2 virtual CPU devices, and both run one
sharded differentiable-render training step over the global 4-device mesh.
This exercises init_distributed's explicit-cluster branch, global-mesh
construction, cross-process replication, and the sharded train step's
gradient all-reduce end to end — everything BASELINE.json's ≥85% @ 2 hosts
target depends on except the physical interconnect.
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, %(repo)r)
import numpy as np
from madarch_tpu.parallel import spmd
from madarch_tpu.core.config import ProbeSettings
from madarch_tpu.examples.scenes import global_illumination

pid = int(sys.argv[1])
assert spmd.init_distributed(%(addr)r, 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

probes = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                       probe_count=(2, 2), grid_dimensions=(2, 2, 1),
                       grid_spacing=(3.0, 3.0, 3.0))
r = global_illumination(width=32, height=32, probes=probes)
mesh = spmd.make_mesh()  # the GLOBAL 4-device mesh
assert mesh.devices.size == 4
data = spmd.replicate(mesh, r.scene_data)
state = spmd.replicate(mesh, r.state)
step = spmd.make_train_step(r.spec, r.probes, r.volumetrics, 32, 32,
                            mesh, screen_cfg=r.screen_cfg)
target = np.zeros((32, 32, 3), np.float32)
loss, data, state = step(data, r.camera, state, target)
loss = float(loss)
assert np.isfinite(loss), loss
print(f"WORKER_OK pid={pid} procs={jax.process_count()} loss={loss}")
"""



def test_two_process_cluster_train_step(tmp_path):
    port = socket.socket()
    port.bind(("localhost", 0))
    addr = f"localhost:{port.getsockname()[1]}"
    port.close()

    code = WORKER % {"repo": REPO, "addr": addr}
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=840)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"WORKER_OK pid={i} procs=2" in out, out[-4000:]
