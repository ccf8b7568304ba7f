"""Chip-side bench gate (`make check-chip`, VERDICT r4 #1c).

`scripts/check_gate.py` runs the bench as a CPU rehearsal, which has no
roofline check, so it cannot see failures that exist only on the card.

This gate runs `python bench.py` on the attached GPU and fails when:
  * the process exits nonzero,
  * the JSON line is missing or unparsable,
  * any ``*_error`` key is present,
  * ``roofline_violations`` is non-empty (a kernel measurement implied
    more HBM bandwidth than the card's data-sheet peak, looked up by
    ``device_kind`` in ``warpdb_tpu.utils.metrics.PEAK_HBM_BYTES_PER_S``
    — a leak, not a result; bench.py itself refuses a device that has
    no peak there).

On success the validated JSON line is printed.
"""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench.py")],
        capture_output=True, text=True, cwd=str(ROOT), timeout=7200,
    )
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:])
        print("check_bench_chip: FAIL — bench exited nonzero")
        return 1
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln]
    try:
        out = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError) as e:
        print(proc.stdout[-4000:])
        print(f"check_bench_chip: FAIL — no JSON line ({e})")
        return 1
    errors = {k: v for k, v in out.items() if k.endswith("_error")}
    if errors:
        print(f"check_bench_chip: FAIL — bench errors: {errors}")
        return 1
    if out.get("roofline_violations"):
        print(
            "check_bench_chip: FAIL — roofline violations: "
            f"{out['roofline_violations']}"
        )
        return 1
    print(json.dumps(out))
    print(
        f"check_bench_chip: OK — device={out.get('device')} "
        f"value={out.get('value')} e2e={out.get('e2e_value')} "
        f"tpch_geomean={out.get('tpch_geomean_rows_per_s')}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
