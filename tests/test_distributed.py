"""Multi-process (2-controller) smoke test for the distributed entry path.

SURVEY.md section 5 "distributed comm backend" row: exercises
`parallel.mesh.init_distributed` + `make_global_mesh` the way a real
multi-host launch does -- two OS processes, a coordinator handshake, a
process-spanning ('dp', 'tp') mesh, and cross-process collectives (psum +
all_gather) over it.  The reference has no distributed anything (SURVEY.md
section 2.4); this pins that our multi-controller wiring actually initializes
and communicates, not just imports.
"""

import os
import socket
import subprocess
import sys

import pytest

_CHILD = r"""
import sys
import jax

# CPU-only: two processes on one host, before any backend initializes.
jax.config.update("jax_platforms", "cpu")

repo, pid, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, repo)
from peba1.parallel import mesh as pmesh

pmesh.init_distributed(coordinator_address="127.0.0.1:" + port,
                       num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
m = pmesh.make_global_mesh(n_tp=1)
assert m.shape["dp"] == len(jax.devices()), m.shape

import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

# One global (dp,)-sharded vector: each process contributes its local rank+1.
sharding = NamedSharding(m, P("dp"))
n_local = len(jax.local_devices())
local = np.full((n_local,), pid + 1, np.int32)
x = jax.make_array_from_process_local_data(sharding, local)

def f(x):
    s = jax.lax.psum(x, "dp")                # cross-process reduction
    g = jax.lax.all_gather(x, "dp", axis=0)  # cross-process gather
    return s, g

fn = jax.jit(jax.shard_map(f, mesh=m, in_specs=P("dp"),
                           out_specs=(P(), P()), check_vma=False))
s, g = fn(x)
got_sum = int(np.asarray(jax.device_get(s))[0])
assert got_sum == 3, got_sum  # 1 + 2 across the two processes
gathered = np.asarray(jax.device_get(g)).reshape(-1)
assert sorted(gathered.tolist()) == [1, 2], gathered
print("proc %d OK" % pid, flush=True)
"""


@pytest.mark.skipif(os.environ.get("PEBA1_NO_SUBPROC") == "1",
                    reason="subprocess tests disabled")
def test_two_process_mesh_collectives(tmp_path):
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    with socket.socket() as s:  # free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # children: 1 CPU device each, no virtual mesh
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), repo, str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True)
        for i in range(2)
    ]
    outs = []
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
    assert "proc 0 OK" in outs[0], outs[0]
    assert "proc 1 OK" in outs[1], outs[1]
