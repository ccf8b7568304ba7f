"""Pre-snapshot gate (`make check`, VERDICT r3 #9).

Runs after the full pytest suite:
1. the TPC-H oracle validation (every suite query vs the NumPy oracle);
2. a bench smoke (CPU rehearsal) at small scale that FAILS on any
   ``*_error`` key in the JSON line — a failure mode that once silently
   dropped the whole TPC-H section from the bench record.

CI and the end-of-round snapshot both run this; a red gate means no
snapshot.
"""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# The gate is a CPU rehearsal: force the CPU backend (with 8 virtual
# devices) through the config API before any backend initialises.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def main() -> int:
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import tpch

    print("check_gate: TPC-H oracle validation @ 20k rows", flush=True)
    tpch.run_check()

    print("check_gate: bench smoke (2^18 rows)", flush=True)
    env = dict(
        os.environ, WARPDB_BENCH_ROWS=str(1 << 18), WARPDB_BENCH_CPU="1"
    )
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench.py")],
        capture_output=True, text=True, env=env, cwd=str(ROOT),
        timeout=3600,
    )
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:])
        print("check_gate: FAIL — bench exited nonzero")
        return 1
    line = proc.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    errors = {k: v for k, v in out.items() if k.endswith("_error")}
    if errors:
        print(f"check_gate: FAIL — bench reported errors: {errors}")
        return 1
    print("check_gate: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
