"""The port's scoreboard against the reference's: the paper's Section III
semantics (twin of ``tests/test_scoreboard.py``) and random workloads
simulated record for record (issue, complete, tag; registers, finish,
makespan, the MCE busy map with its zero entries, the stalls)."""

import random

import pytest

from _hypothesis_compat import given, settings, st
from _torch_timing import ALL_DEVICES, machines, outcome, sim_view, workloads
from repro.core import scoreboard as ref_scoreboard
from repro_torch.core import isa
from repro_torch.core.machine import get_machine
from repro_torch.core.microbench import build_listing1, t_total
from repro_torch.core.program import (Wavefront, Workload, mfma, s_memtime,
                                      v_alu)
from repro_torch.core.scoreboard import (IssueRecord, SimResult, WFResult,
                                         simulate, simulate_program)

M200 = get_machine("mi200")
LAT = M200.mfma_cycles("fp32_16x16x16fp16")  # 32
SCALES = (0.5, 1.0, 1.5, 2.0, 3.7)


def _chain(n, name="fp32_16x16x16fp16"):
    """n data-dependent MFMAs (D=C accumulate chain)."""
    return [mfma(name, d="d", a="a", b="b", c="d", tag=f"m{i}")
            for i in range(n)]


def _indep(n, name="fp32_16x16x16fp16"):
    return [mfma(name, d=f"d{i}", a=f"a{i}", b=f"b{i}", c=f"c{i}")
            for i in range(n)]


def test_no_intra_wf_pipelining_dependent():
    """Dependent MFMAs serialise at full latency."""
    res = simulate_program(M200, _chain(4))
    issues = [r.issue for r in res.records if r.opcode == "mfma"]
    assert [b - a for a, b in zip(issues, issues[1:])] == [LAT] * 3


def test_no_intra_wf_pipelining_independent():
    """Even INDEPENDENT MFMAs on one SIMD can't overlap in the MCE: the
    NRDY_MATRIX_CORE counter drains first (no multi-stage pipelining)."""
    res = simulate_program(M200, _indep(4))
    issues = [r.issue for r in res.records if r.opcode == "mfma"]
    assert [b - a for a, b in zip(issues, issues[1:])] == [LAT] * 3


def test_cross_simd_parallelism():
    """WFs on different SIMD units use different MCEs concurrently."""
    wfs = [Wavefront(i, _indep(4), cu=0, simd=i) for i in range(4)]
    res = simulate(M200, Workload(wfs))
    solo = simulate(M200, Workload([Wavefront(0, _indep(4), cu=0, simd=0)]))
    assert res.makespan == solo.makespan  # 4 SIMDs: perfect overlap
    assert res.mce_utilization(M200) == solo.mce_utilization(M200)


def test_same_simd_wfs_serialise():
    """Two WFs on the same SIMD contend for its single MCE."""
    wfs = [Wavefront(i, _indep(2), cu=0, simd=0) for i in range(2)]
    res = simulate(M200, Workload(wfs))
    assert res.makespan >= 4 * LAT
    assert res.stall_cycles.get("nrdy_matrix_core", 0) > 0


def test_independent_valu_overlaps_mce():
    """Non-MCE work without data deps proceeds while the MCE is busy."""
    prog = [mfma("fp32_16x16x16fp16", d="d", a="a", b="b", c="c"),
            v_alu("x", "y"),
            v_alu("z", "x")]
    mf, va1, va2 = simulate_program(M200, prog).records
    assert va1.issue < mf.complete and va2.issue < mf.complete


def test_dependent_valu_stalls_on_mfma():
    prog = [mfma("fp32_16x16x16fp16", d="d", a="a", b="b", c="c"),
            v_alu("x", "d")]  # reads MFMA result
    mf, va = simulate_program(M200, prog).records
    assert va.issue >= mf.complete


def test_memtime_samples_issue_cycle():
    res = simulate_program(M200, [s_memtime("t0", tag="t0"),
                                  s_memtime("t1", tag="t1")])
    # blocking: second probe issues exactly t_memtime later
    assert res.value("t1") - res.value("t0") == M200.t_memtime


def test_results_and_errors():
    res = simulate(M200, Workload([Wavefront(0, _chain(2))]))
    assert isinstance(res, SimResult) and isinstance(res.wf[0], WFResult)
    assert all(isinstance(r, IssueRecord) for r in res.wf[0].records)
    assert res.wf[0].by_tag("m1").index == 1
    with pytest.raises(KeyError):
        res.wf[0].by_tag("nope")
    assert simulate(M200, Workload([])).mce_utilization(M200) == 0.0
    from repro_torch.core.program import Instr
    with pytest.raises(ValueError, match="unknown opcode 'v_bogus'"):
        simulate_program(M200, [Instr("v_bogus")])
    with pytest.raises(isa.UnsupportedInstructionError):
        simulate_program("mi300", _chain(2, "i32_16x16x16i8"))


# -- record-for-record parity on random workloads ------------------------------

_OPS = ("mfma", "mfma", "mfma", "s_memtime", "s_nop", "s_waitcnt", "v_alu",
        "v_load", "ds_load", "s_load")
_REGS = ("r0", "r1", "r2", "r3", "r4", "r5")


def _random_wfs(rng: random.Random, device: str):
    """1-12 wavefronts over 2 CUs x 4 SIMDs, each 1-10 instructions of
    every opcode over six registers; MFMAs from the device's supported
    set.  One workload in five may also name an MFMA the device lacks
    (on a device with no table, any MFMA), which must raise alike."""
    port = get_machine(device)
    good = list(port.supported_instructions()) if port.has_mfma_table \
        else []
    bad = ["i32_16x16x16i8", "fp32_32x32x8fp16"]
    allow_bad = rng.random() < 0.2
    ops_set = _OPS if good or allow_bad else \
        tuple(op for op in _OPS if op != "mfma")
    wfs = []
    for w in range(rng.randint(1, 12)):
        ops = []
        for i in range(rng.randint(1, 10)):
            op = rng.choice(ops_set)
            r = [rng.choice(_REGS) for _ in range(4)]
            tag = f"t{i}" if rng.random() < 0.5 else None
            if op == "mfma":
                pool = bad + good if allow_bad else good
                kw = dict(name=rng.choice(pool), d=r[0], a=r[1], b=r[2],
                          c=r[3], tag=tag)
            elif op == "v_alu":
                kw = dict(d=r[0], srcs=r[1:rng.randint(1, 4)])
            else:
                kw = dict(d=r[0], tag=tag)
            ops.append((op, kw))
        wfs.append((w, rng.randint(0, 1), rng.randint(0, 3), ops))
    return wfs


def _parity(seed: int, device: str, scale: float):
    rng = random.Random(seed)
    port_m, ref_m = machines(device, mfma_scale=scale)
    port_w, ref_w = workloads(_random_wfs(rng, device))
    got = outcome(lambda: sim_view(simulate(port_m, port_w)))
    want = outcome(lambda: sim_view(ref_scoreboard.simulate(ref_m, ref_w)))
    assert got == want


@pytest.mark.parametrize("seed", range(24))
def test_random_workloads_equal_reference(seed):
    """Seeded draws over every device and scale (the H100's reference
    twin built from its spec): the same records, or the same error."""
    rng = random.Random(1000 + seed)
    _parity(seed, rng.choice(ALL_DEVICES), rng.choice(SCALES))


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), device=st.sampled_from(ALL_DEVICES),
       scale=st.sampled_from(SCALES))
def test_property_random_workloads_equal_reference(seed, device, scale):
    _parity(seed, device, scale)


@settings(max_examples=50, deadline=None)
@given(n=st.integers(2, 8),
       name=st.sampled_from(["fp64_16x16x4fp64", "fp32_4x4x1fp32",
                             "fp32_16x16x4fp32", "fp32_16x16x16fp16",
                             "fp64_4x4x4fp64", "fp32_4x4x4fp16"]))
def test_property_chain_time_linear(n, name):
    """T_total of a dependent chain == (N-1)*lat + t_memtime + t_inst
    (the closed form Eq. 1 inverts) for every instruction and N."""
    lat = M200.mfma_cycles(name)
    res = simulate_program(M200, build_listing1(name, n))
    assert t_total(res) == (n - 1) * lat + M200.t_memtime + M200.t_inst


@settings(max_examples=40, deadline=None)
@given(n_wf=st.integers(1, 12), tiles=st.integers(1, 8))
def test_property_makespan_bounds(n_wf, tiles):
    """Makespan is bounded by work/TPUT below and serial execution above."""
    wfs = [Wavefront(i, _indep(tiles), cu=0, simd=i % M200.simd_per_cu)
           for i in range(n_wf)]
    res = simulate(M200, Workload(wfs))
    total = n_wf * tiles
    lower = -(-total // M200.simd_per_cu) * LAT  # ceil division
    assert lower <= res.makespan <= total * LAT
