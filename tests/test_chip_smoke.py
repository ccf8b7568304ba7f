"""CPU rehearsal of chip_smoke.py: every phase's oracle checks at tiny
sizes, the refusal to run without a GPU, and that a wrong answer fails
a phase."""

import jax
import numpy as np
import pytest

import chip_smoke

chip_smoke.add_paths()


def test_chip_smoke_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert "no GPU" in err
    assert '"ok"' not in out


@pytest.mark.parametrize("phase", ["A", "B", "C", "D"])
def test_chip_smoke_phase_rehearsal(phase, capsys):
    if phase == "A":
        chip_smoke.phase_a(jax, 1 << 13, seed=1)
    elif phase == "B":
        chip_smoke.phase_b(jax, 1 << 12, seed=1)
    elif phase == "C":
        chip_smoke.phase_c(jax, 1 << 12, seed=1, names=("q1", "q6", "q13"))
    else:
        from warpdb_tpu import WarpDB
        from warpdb_tpu.storage import HostTable

        db = WarpDB(HostTable.from_dict(chip_smoke.make_table(1 << 12, 1)))
        chip_smoke.phase_d(jax, db)
    out = capsys.readouterr().out
    assert f"phase {phase}: rows" in out and "oracle: pass" in out


def test_chip_smoke_sharded_rehearsal(tmp_path, capsys):
    chip_smoke.phase_sharded(jax, 4, 1 << 13, 1, str(tmp_path))
    out = capsys.readouterr().out
    assert "phase S4: rows 8192" in out
    assert "collectives group_combine" in out


def test_chip_smoke_wrong_answer_fails(monkeypatch):
    """A perturbed engine result must fail the phase's oracle check."""
    from warpdb_tpu import WarpDB

    real = WarpDB.query_sql_table

    def off_by_one(self, sql):
        out = dict(real(self, sql))
        if "c" in out:
            c = np.asarray(out["c"], np.float64)
            c[0] += 1
            out["c"] = c
        return out

    monkeypatch.setattr(WarpDB, "query_sql_table", off_by_one)
    with pytest.raises(AssertionError):
        chip_smoke.phase_b(jax, 1 << 12, seed=1)
