"""Helpers shared by the timing-model tests (``tests/test_torch_machine.py``,
``test_torch_scoreboard.py``, ``test_torch_microbench.py``,
``test_torch_paper_tables.py``, ``test_torch_overlay.py``,
``test_torch_whatif.py``): the reference's twin of a port spec or
machine, the same workload built in both packages, and simulation
results in a form that compares record for record."""

import dataclasses

from repro.arch import spec as ref_spec
from repro.core import machine as ref_machine
from repro.core import program as ref_program
from repro_torch.arch import get_device
from repro_torch.core import machine, program

#: The reference's scale set (tests/test_arch_registry.py).
SCALES = (0.25, 0.5, 1.0, 1.5, 2.0, 3.7)
#: The reference's five devices; the port registers them and the H100.
REF_DEVICES = ("mi200", "mi300", "mi300x", "tpu_v5e", "tpu_v5p")
ALL_DEVICES = ("h100",) + REF_DEVICES
TABLE_DEVICES = ("mi200", "mi300", "mi300x")


def ref_spec_of(spec):
    """The port's ``DeviceSpec`` rebuilt as the reference's, field for
    field (the H100 is in no reference catalog)."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    fields["memory"] = ref_spec.MemoryHierarchy(
        **dataclasses.asdict(spec.memory))
    fields["interconnect"] = ref_spec.Interconnect(
        **dataclasses.asdict(spec.interconnect))
    fields["cycle_table"] = {k: ref_spec.CycleEntry(e.cycles, e.validated)
                             for k, e in spec.cycle_table.items()}
    return ref_spec.DeviceSpec(**fields)


def machines(name: str, *, mfma_scale: float = 1.0):
    """(port machine, reference machine) for device ``name``; the H100's
    reference twin is built from the port's spec."""
    port = machine.get_machine(name, mfma_scale=mfma_scale)
    if name in REF_DEVICES:
        ref = ref_machine.get_machine(name, mfma_scale=mfma_scale)
    else:
        ref = ref_machine.MachineModel.from_spec(
            ref_spec_of(get_device(name)), mfma_scale=mfma_scale)
    return port, ref


def fields_of(m):
    """A machine's compared fields (``spec`` is compare=False in both)."""
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
            if f.name != "spec"}


def outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("raises", exception class name, message)``:
    what a call did, comparable across the packages."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:      # noqa: BLE001 - the class is compared
        return ("raises", type(e).__name__, str(e))


def build_program(pkg, ops):
    """``ops`` [(opcode, kwargs)] as ``pkg``'s Instr list."""
    out = []
    for op, kw in ops:
        if op == "mfma":
            out.append(pkg.mfma(kw["name"], d=kw["d"], a=kw["a"], b=kw["b"],
                                c=kw["c"], tag=kw.get("tag")))
        elif op == "v_alu":
            out.append(pkg.v_alu(kw["d"], *kw["srcs"]))
        elif op in ("s_memtime", "v_load"):
            out.append(getattr(pkg, op)(kw["d"], tag=kw.get("tag")))
        elif op in ("ds_load", "s_load"):
            out.append(getattr(pkg, op)(kw["d"]))
        else:
            out.append(getattr(pkg, op)())
    return out


def workloads(wfs):
    """``wfs`` [(wf_id, cu, simd, ops)] as (port, reference) workloads."""
    def make(pkg):
        return pkg.Workload([pkg.Wavefront(w, build_program(pkg, ops),
                                           cu=cu, simd=simd)
                             for w, cu, simd, ops in wfs])
    return make(program), make(ref_program)


def sim_view(res):
    """A SimResult as plain data: every WF's records (issue, complete,
    tag and the rest), registers and finish, the makespan, the MCE busy
    map (zero entries included) and the stalls."""
    return {
        "wf": {w: ([dataclasses.astuple(r) for r in wf.records],
                   dict(wf.regs), wf.finish) for w, wf in res.wf.items()},
        "makespan": res.makespan,
        "mce_busy": dict(res.mce_busy),
        "stall_cycles": dict(res.stall_cycles),
    }
