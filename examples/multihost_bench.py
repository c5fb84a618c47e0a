"""Multi-host (DCN) data-parallel ingest + build, MEASURED.

The recipe `tests/test_multihost.py` proves functionally, at bench size:
two separate processes (the JAX stand-in for two hosts -- same code runs
on real multi-host accelerators by swapping the coordinator address and dropping
the CPU forcing), each

  1. ingesting ONLY its own shard of the rows from its own .fvecs file
     (per-host ingest; `jax.make_array_from_process_local_data`), then
  2. running the data-parallel forest build SPMD -- the distributed
     radix-median collectives run across hosts and devices,

and every host gets the same replicated tree structure back.  Prints
per-host ingest MB/s, build wall, and a structure-equality check.  The
reference has no
distributed story at all (SURVEY.md section 2.11).

    python examples/multihost_bench.py [n_rows] [dim]
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import os, sys, time
proc = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
n = int(sys.argv[4]); dim = int(sys.argv[5]); tmp = sys.argv[6]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=proc)
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, %(repo)r)
from rptree_tpu.parallel.data_parallel import (
    DATA_AXIS, data_mesh, forest_batch_data_parallel)
from rptree_tpu.utils import ingest

# stage 1: per-host shard ingest (each host reads ONLY its own file)
t0 = time.perf_counter()
x_local = ingest.read_fvecs(os.path.join(tmp, f"shard{proc}.fvecs"))
ingest_s = time.perf_counter() - t0
mb = x_local.nbytes / 1e6
mesh = data_mesh()  # all global devices (4 per process)
sharding = NamedSharding(mesh, P(DATA_AXIS))
t0 = time.perf_counter()
xs = jax.make_array_from_process_local_data(sharding, x_local, (n, dim))
upload_s = time.perf_counter() - t0

# stage 2: SPMD distributed-median build (collectives across hosts)
from rptree_tpu.config import rp_tree_cfg

min_leaf = max(16, n // 256)
cfg = rp_tree_cfg(min_leaf, n, dim)
t0 = time.perf_counter()
f = forest_batch_data_parallel(7, cfg.max_depth, min_leaf, 4, 1.0, xs,
                               mesh=mesh)
repl = NamedSharding(mesh, P())
fetch = jax.jit(lambda a: a, out_shardings=repl)
thr0 = np.asarray(fetch(f.arrays.thr[0]))  # forces build completion
build_s = time.perf_counter() - t0

# steady-state build (same shapes -> compile cached in-process)
t0 = time.perf_counter()
f2 = forest_batch_data_parallel(8, cfg.max_depth, min_leaf, 4, 1.0, xs,
                                mesh=mesh)
np.asarray(fetch(f2.arrays.thr[0]))
build_warm_s = time.perf_counter() - t0

# every host must hold the SAME replicated structure
import hashlib
h = hashlib.sha1(np.ascontiguousarray(thr0).tobytes()).hexdigest()[:12]
print(f"RESULT proc={proc} ingest_mb={mb:.0f} ingest_s={ingest_s:.2f} "
      f"upload_s={upload_s:.2f} build_cold_s={build_s:.2f} "
      f"build_warm_s={build_warm_s:.2f} thr_sha={h}", flush=True)
"""


def main(n=262144, dim=64, nproc=2):
    import tempfile

    rng = np.random.default_rng(11)
    with tempfile.TemporaryDirectory() as tmp:
        # write one .fvecs shard per host (the per-host ingest source)
        sys.path.insert(0, REPO)
        from rptree_tpu.utils.ingest import write_fvecs

        per = n // nproc
        for p in range(nproc):
            write_fvecs(os.path.join(tmp, f"shard{p}.fvecs"),
                        rng.normal(size=(per, dim)).astype(np.float32))
        child = os.path.join(tmp, "child.py")
        with open(child, "w") as fh:
            fh.write(_CHILD % {"repo": REPO})
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, child, str(i), str(nproc), port,
                 str(n), str(dim), tmp],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            for i in range(nproc)
        ]
        logs = [p.communicate(timeout=1200)[0] for p in procs]
        wall = time.perf_counter() - t0
        shas = set()
        for log in logs:
            for line in log.splitlines():
                if line.startswith("RESULT"):
                    print(line)
                    shas.add(line.rsplit("thr_sha=", 1)[1])
        if any(p.returncode != 0 for p in procs):
            for log in logs:
                print(log[-2000:])
            raise SystemExit("multi-host bench failed")
        assert len(shas) == 1, f"hosts disagree on the structure: {shas}"
        print(f"hosts agree (thr sha {shas.pop()}); end-to-end wall "
              f"{wall:.1f}s for n={n} dim={dim} over {nproc} hosts")


if __name__ == "__main__":
    a = sys.argv[1:]
    main(*(int(v) for v in a[:2]))
