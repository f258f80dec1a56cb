"""The paper's report tables and intermittency model in the port
(``repro_torch.api.reports``, ``repro_torch.core.compressor``,
``repro_torch.pim.intermittent``) against the reference, exactly.

Every number here is arithmetic over plan geometry or a seeded numpy
simulation, so the port must give the reference's floats bit for bit:
``==`` throughout, no tolerance.  The one field that differs by design is
``paper_claims``' plan ``fingerprint`` (the port compiles for ``cuda``, the
reference for ``cpu``), compared separately against the port's own plan.
"""
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.api import reports as jreports  # noqa: E402
from repro.core import compressor as jcomp  # noqa: E402
from repro.pim import intermittent as jint  # noqa: E402
from repro_torch.api import reports  # noqa: E402
from repro_torch.core import compressor as comp  # noqa: E402
from repro_torch.pim import intermittent as tint  # noqa: E402

DESIGNS = ("proposed", "imce", "reram", "asic", "sot_mram", "cmos_asic")


@pytest.mark.parametrize("dataset", ["imagenet", "svhn", "mnist"])
@pytest.mark.parametrize("bits", [(1, 1), (4, 1), (8, 1), (2, 2)])
def test_simulate_rows_equal_the_reference(dataset, bits):
    for design in DESIGNS:
        assert reports.simulate(design, dataset, *bits) == jreports.simulate(
            design, dataset, *bits), design


@pytest.mark.parametrize("bits", [(1, 1), (4, 1)])
def test_table2_equals_the_reference(bits):
    assert reports.table2(*bits) == jreports.table2(*bits)


def test_fig9_fig10_equal_the_reference():
    assert reports.fig9_fig10() == jreports.fig9_fig10()
    assert reports.fig9_fig10(((1, 2),)) == jreports.fig9_fig10(((1, 2),))


@pytest.mark.parametrize("dataset", ["imagenet", "svhn", "mnist"])
def test_paper_claims_equal_the_reference(dataset):
    got, ref = reports.paper_claims(dataset), jreports.paper_claims(dataset)
    assert len(got) == len(ref) == 3
    own = reports._dataset_compiled(dataset, 1, 1).fingerprint()
    for g, r in zip(got, ref):
        assert g.pop("fingerprint") == own
        r.pop("fingerprint")
        assert g == r


def test_calibrate_and_constants_equal_the_reference():
    assert reports.calibrate() == jreports.calibrate()
    assert reports.TABLE2 == jreports.TABLE2
    assert reports.CLAIMS == jreports.CLAIMS
    assert reports.TABLE2_SVHN_CHANNELS == jreports.TABLE2_SVHN_CHANNELS
    # the port's ConvSpec adds ``groups`` (1 here) to the reference's
    assert [dict(vars(s), groups=1) for s in jreports.lenet_spec()] == [
        vars(s) for s in reports.lenet_spec()]


def test_report_plans_are_structure_only_cuda_plans():
    c = reports._dataset_compiled("svhn", 1, 1)
    assert c.plan.params is None and c.plan.backend == "cuda"
    assert c.plan.model == "svhn"


# ---------------------------------------------------------------------------
# the 4:2 compressor and the NV-FA timing
# ---------------------------------------------------------------------------

def test_compressor_truth_table_equals_the_reference():
    for bits in itertools.product((0, 1), repeat=5):
        got = comp.compressor_outputs(*bits)
        assert got == jcomp.compressor_outputs(*bits)
        s, carry, cout = got
        assert sum(bits) == s + 2 * (carry + cout)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 17, 64, 512, 1000])
def test_tree_depth_and_cycles_equal_the_reference(n):
    assert comp.tree_depth(n) == jcomp.tree_depth(n)
    assert comp.compressor_cycles(n) == jcomp.compressor_cycles(n)
    assert comp.serial_counter_cycles(n) == jcomp.serial_counter_cycles(n)
    assert comp.compress_vector([1] * n) == jcomp.compress_vector([1] * n)
    assert comp.asr_shift_cycles(n, 2) == jcomp.asr_shift_cycles(n, 2)


@pytest.mark.parametrize("m,n", [(1, 1), (1, 8), (4, 4), (8, 8)])
def test_nvfa_window_equals_the_reference(m, n):
    assert comp.NVFATiming().vulnerable_window_ps(m, n) == \
        jcomp.NVFATiming().vulnerable_window_ps(m, n)
    assert comp.NVFATiming(40.0).vulnerable_window_ps(m, n) == \
        jcomp.NVFATiming(40.0).vulnerable_window_ps(m, n)


# ---------------------------------------------------------------------------
# forward progress under intermittent power
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("period", [0, 1, 5, 20])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("resume_us", [0.0, 250.0])
def test_forward_progress_equals_the_reference(period, seed, resume_us):
    kw = dict(n_frames=200, frame_time_us=100.0, mtbf_us=700.0,
              checkpoint_period_frames=period, seed=seed,
              resume_us=resume_us)
    assert tint.forward_progress(**kw) == jint.forward_progress(**kw)


def test_forward_progress_validation_equals_the_reference():
    for bad in (dict(n_frames=0), dict(frame_time_us=0.0),
                dict(mtbf_us=-1.0), dict(checkpoint_period_frames=-1),
                dict(nv_write_us=-1.0), dict(resume_us=-1.0)):
        kw = dict(dict(n_frames=10, frame_time_us=1.0, mtbf_us=10.0,
                       checkpoint_period_frames=2), **bad)
        with pytest.raises(ValueError):
            tint.forward_progress(**kw)
        with pytest.raises(ValueError):
            jint.forward_progress(**kw)


def test_sweep_checkpoint_period_equals_the_reference():
    kw = dict(periods=(0, 2, 20), n_frames=100, repeats=3, seed=7)
    assert tint.sweep_checkpoint_period(**kw) == \
        jint.sweep_checkpoint_period(**kw)
    got = tint.sweep_checkpoint_period(periods=(5,), n_frames=50, repeats=2,
                                       rng=np.random.RandomState(9))
    ref = jint.sweep_checkpoint_period(periods=(5,), n_frames=50, repeats=2,
                                       rng=np.random.RandomState(9))
    assert got == ref


def test_plan_resume_study_equals_the_reference():
    kw = dict(compile_us=20000.0, plan_load_us=300.0, n_frames=100,
              repeats=4, seed=2)
    got, ref = tint.plan_resume_study(**kw), jint.plan_resume_study(**kw)
    assert got == ref
    assert got["efficiency_gain"] > 1.0
    with pytest.raises(ValueError):
        tint.plan_resume_study(1.0, 1.0, repeats=0)
    with pytest.raises(TypeError):
        tint.plan_resume_study(1.0, 1.0, rng=3)
