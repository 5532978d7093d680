"""Program auditor: checks over one run of a freshly-built program.

The reference audits the jaxpr of every freshly-compiled program: foreign
host callbacks inside traced code, a float32 value quietly widened to
float64, a profile counter on a sharded stage that is not psum-shaped, and
capacity-sized constants baked into the trace. The port runs eagerly:
there is no jaxpr, and a program is the Python callable that
`sql/physical.compile_plan` (or `sql/distributed.compile_distributed`)
returns. Each check is re-derived for that world or recorded as not
applicable:

- **f64-promotion** (re-derived): the program's first run goes through a
  torch dispatch mode (`audit_run`). An operator that takes a float32
  tensor of one or more dimensions, and gives a float64 tensor without
  being a cast (`aten._to_copy`, `copy_`), promoted the column implicitly
  — the reference's finding, warn severity. An explicit `.to(float64)` at
  a column boundary is what the finding asks for, so it does not count.
- **non-psum-counter / subgroup-psum-counter** (re-derived): a
  `~ctr_` profile counter of a sharded stage must be the SUM of the
  shards' counts over the whole mesh. While the run is audited the mesh
  records every reduction it makes (`Mesh.psum/pmax/pmin`,
  parallel/mesh.py); a counter produced by a max or min is
  `non-psum-counter` (the host keeps one shard's count), and one summed
  over fewer shards than the mesh holds is `subgroup-psum-counter` (each
  group keeps its own partial). `check_counters` reads the record.
- **host-callback** (not applicable): in the reference a Python callback
  inside a compiled program serializes the device pipeline. An eager
  program runs every operator from the host thread, so a Python call is
  an ordinary call; what stalls the card is a host read of a device
  value, which effects_check's device-wait rule names at source level
  (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `.synchronize()`).
- **capacity-leak** (not applicable): nothing is baked. A program is
  rebuilt by `compile_plan` for each capacity set, and stats-derived
  arrays are computed per run or held by the DeviceCache as inputs, so no
  value outlives the capacities it was made for inside a compiled
  artifact.
"""

from __future__ import annotations

from . import Finding

_CASTS = frozenset({"aten._to_copy.default", "aten.copy_.default",
                    "aten.copy.default", "aten._to_copy.out"})


def _tensors(x, out):
    import torch

    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _audit_mode():
    """A TorchDispatchMode that records implicit float32 -> float64
    promotions (built lazily: importing this module needs no torch)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Audit(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.promotions = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if name not in _CASTS:
                ins = _tensors((args, kwargs), [])
                if any(t.dtype == torch.float32 and t.dim() > 0
                       for t in ins) and any(
                        t.dtype == torch.float64
                        for t in _tensors(out, [])):
                    self.promotions.append(name)
            return out

    return _Audit()


class RunAudit:
    """What one audited run saw: implicit promotions (op names) and the
    mesh's reductions (id(result) -> (op, shards reduced, mesh shards))."""

    def __init__(self):
        self.promotions: list = []
        self.reductions: dict = {}
        self._keep: list = []  # the reduced tensors: their ids stay unique

    def note_reduction(self, op: str, n_in: int, n_mesh: int, out):
        self._keep.append(out)
        self.reductions[id(out)] = (op, n_in, n_mesh)


def audit_run(run, mesh=None):
    """(run()'s result, RunAudit): `run` executed once under the dispatch
    mode, with `mesh`'s reductions recorded (parallel/mesh.py
    `Mesh.observing`)."""
    import contextlib

    audit = RunAudit()
    mode = _audit_mode()
    observe = (mesh.observing(audit.note_reduction) if mesh is not None
               else contextlib.nullcontext())
    with observe, mode:
        out = run()
    audit.promotions = list(mode.promotions)
    return out, audit


def check_promotions(audit: RunAudit) -> list:
    seen = {}
    for name in audit.promotions:
        seen[name] = seen.get(name, 0) + 1
    return [Finding(
        "trace_check", "f64-promotion", name,
        f"float32 value promoted to float64 inside the program ({n}x): "
        "doubles the bytes moved and halves the float32 lanes; cast "
        "explicitly at the column boundary if intended", severity="warn")
        for name, n in sorted(seen.items())]


def check_counters(checks: dict, audit: RunAudit) -> list:
    """Findings for `~ctr_` counters whose value came out of a reduction
    that is not the full-mesh sum."""
    findings = []
    for key in sorted(checks):
        if not key.startswith("~ctr_"):
            continue
        prov = audit.reductions.get(id(checks[key]))
        if prov is None:
            continue  # a replicated stage's value, or a host integer
        op, n_in, n_mesh = prov
        if op != "sum":
            findings.append(Finding(
                "trace_check", "non-psum-counter", key,
                f"profile counter on a sharded stage merged by {op}: each "
                "shard holds its own count and the merge keeps one "
                "shard's value"))
        elif n_in < n_mesh:
            findings.append(Finding(
                "trace_check", "subgroup-psum-counter", key,
                f"profile counter summed over {n_in} of the mesh's "
                f"{n_mesh} shards: each group keeps its own partial — sum "
                "over the whole mesh before any merge"))
    return findings


def audit_program(run, checks_of=None, mesh=None):
    """(run()'s result, findings) of one audited run. `checks_of(result)`
    gives the run's checks dict for the counter check over `mesh`'s
    reductions (None: no counters)."""
    out, audit = audit_run(run, mesh)
    findings = check_promotions(audit)
    if checks_of is not None:
        findings += check_counters(checks_of(out), audit)
    return out, findings
