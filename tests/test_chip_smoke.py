"""chip_smoke.py's phases at tiny sizes on the CPU (every comparison must
pass its bound), its refusal to run without a GPU, and the phases on a real
card under the ``gpu`` marker."""
import numpy as np
import pytest

import chip_smoke


def _run(phase, **kwargs):
    checks = chip_smoke.Checks()
    out = phase(checks, **kwargs)
    assert checks.failures == []
    return out


def test_phase1_main_tiny():
    out = _run(chip_smoke.phase1_main, n=2_000, n_query=40, n_steps=3)
    assert out["lml_ms"] > 0 and out["step_ms"] > 0


def test_phase2_parity_tiny():
    out = _run(chip_smoke.phase2_parity, T=300, n_dense=120)
    assert set(out) == {"Matern32", "Matern52"}


def test_phase3_co2_tiny():
    out = _run(chip_smoke.phase3_co2, n=60, qp_order=1)
    assert np.isfinite(out["tf32_default_rel_err"])


def test_phase4_chains_tiny():
    out = _run(chip_smoke.phase4_chains, n_chains=4, T=128, n_samples=2)
    assert {"batched_vg_ms_chunk_32", "batched_vg_ms_chunk_None"} <= set(out)


def test_phase5_stable_tiny():
    _run(chip_smoke.phase5_stable, T=128, order=4)


def test_multi_mesh_tiny():
    """The --multi comparison on 4 of the 8 virtual CPU devices: the inputs
    are sharded over all four and agree with the one-device model."""
    out = _run(chip_smoke.multi_mesh, n=4_000, n_devices=4, n_query=50)
    assert out["mesh_lml_ms"] > 0


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_checks_record_failures():
    checks = chip_smoke.Checks()
    checks.check("within", 1e-9, 1e-6)
    checks.check("beyond", 1e-3, 1e-6)
    checks.check("nan", float("nan"), 1.0)
    checks.require("false", False)
    assert checks.failures == ["beyond", "nan", "false"]


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    """Phases 2 and 4 at reduced sizes on the card; the full run is
    ``python chip_smoke.py``."""
    assert chip_smoke.phase0_device()["platform"] == "gpu"
    _run(chip_smoke.phase2_parity, T=4_096, n_dense=512)
    _run(chip_smoke.phase4_chains, n_chains=8, T=4_096, n_samples=2)


def test_prefetched_program_is_used():
    """A program compiled ahead on the worker pool is the one the phase
    runs, and gives the same checks as compiling inline."""
    checks = chip_smoke.Checks(workers=1)
    checks.prefetch(chip_smoke.phase5_programs(T=128, order=4))
    chip_smoke.phase5_stable(checks, T=128, order=4)
    checks.close()
    assert checks.failures == [] and checks._pending == {}
