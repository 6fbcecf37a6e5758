"""The cost of one step of the port, counted as it runs: the H100
counterpart of ``repro/analysis/hlo_cost.py``.

The reference compiles a step with XLA and walks the compiled HLO,
multiplying each ``while`` body by its trip count. The port runs eagerly:
there is no HLO and no fusion, so a step's cost is what its ops do as they
run. ``count_step(fn, *args)`` runs ``fn`` once under ``Counter``, a
``TorchDispatchMode`` that sees every aten op of the forward, of the
backward (autograd's engine carries the mode into its threads) and of the
remat recomputes, on meta tensors (the dry run: nothing allocated or
computed) or on the card's tensors (the same ops, so the same counts):

  * FLOPs: matmul-family ops as ``torch.utils.flop_counter`` counts them,
    keyed by their operands' dtype (the tensor cores' rate for bf16);
    elementwise ops by output numel and reductions by input numel (the
    reference's rule), keyed ``"vector"`` (the CUDA cores' rate, whatever
    the type); ``_grouped_mm`` as 2 x rows x d x f, whatever the routing
    (on meta tensors the counter also gives its output, which torch's
    meta function refuses to give for f32);
  * bytes: each op's operands plus its outputs (``copy_`` and the fills
    write their output without reading it); views, metadata and
    allocation are free. Eager execution has no fusion, so these are the
    bytes it moves;
  * the kernels: ``elementwise_2d`` and ``glu_2d`` count once at their
    entry from the kernel's own work (``kernels/epilogue.py::
    elementwise_work`` / ``glu_work``), never what runs inside (the plain
    route's one-hot lookups are work the kernel never does), on every
    route; on meta tensors the entry keeps its meta contract (an empty
    output of the right shape);
  * collectives: the mesh's ``TPGroup`` / ``DPGroup`` counters, by axis
    and kind, each collective's result bytes (the reference's convention;
    they count as HBM bytes too, as there);
  * memory: the bytes of the storages the step allocates on its device,
    live (freed when the last tensor on them dies) and at their peak, and
    the bytes of its outputs, fresh or aliasing an input.

``count_cell`` counts a dry-run cell (``launch/steps.py::build_cell``)
with the reference's trip-count rule in place of running every layer and
time step: each block kind (a layer's activation config; one for a
uniform model) is counted once, as the difference between a count with
one layer of each kind and one with a second layer of that kind, and
multiplied by the kind's count; a Mamba time step likewise, as the
difference between counts of a 3-step and a 2-step scan, times S. Every
count is affine in those numbers, so the result equals the count of the
whole model (``whole=True``), which tests hold it to.

``count_step`` takes the place of ``analyze_hlo`` / ``analyze_compiled``.
``xla_cost_analysis`` (XLA's own numbers for a compiled module) and the
HLO-text parser (``parse_module``, ``Instr``, ``Computation``) have no
counterpart: there is no compiled module, so no HLO.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter")

_aten = torch.ops.aten
# ops that move nothing: allocation, views without an alias annotation,
# reads of metadata
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
         _aten.lift_fresh, _aten.detach, _aten.alias}
# reductions that carry no reduction tag, counted by input numel
_REDUCTIONS = {_aten._softmax, _aten._log_softmax, _aten.cumsum,
               _aten._softmax_backward_data, _aten._log_softmax_backward_data}
# the reference's transcendentals (exponential, tanh, log, logistic, erf,
# power, sine, cosine)
_TRANSCENDENTAL = {_aten.exp, _aten.tanh, _aten.log, _aten.sigmoid,
                   _aten.erf, _aten.pow, _aten.sin, _aten.cos}
# ops that write their output without reading it: (the operands read)
_WRITE_ONLY = {_aten.copy_: slice(1, 2), _aten.fill_: slice(0, 0),
               _aten.zero_: slice(0, 0)}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CostTotals:
    """One rank's cost of a step. The reference's fields, then the port's:
    ``flops_by_dtype`` (matmul-family FLOPs by operand dtype, the rest
    under ``"vector"``), ``collectives_by_axis`` ({axis: {kind: [calls,
    bytes]}}), ``kernels`` (launches by kernel) and ``memory``
    (``argument_bytes``, ``output_bytes``, ``alias_bytes`` of the outputs
    that are inputs' storage, ``peak_bytes`` of the step's allocations,
    ``temp_bytes`` = that peak less the fresh outputs)."""
    flops: int = 0
    bytes: int = 0
    collective_bytes: int = 0
    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    count_by_kind: dict = dataclasses.field(default_factory=dict)
    transcendentals: int = 0
    profile: list = dataclasses.field(default_factory=list)
    # profile rows: (bytes or flops, "bytes" | "flops", op, output shape)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    collectives_by_axis: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)

    def add_flops(self, key: str, n: int) -> None:
        self.flops += n
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0) + n

    def add_collective(self, axis: str, kind: str, calls: int, nbytes: int):
        self.collective_bytes += nbytes
        self.bytes += nbytes
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + calls
        c = self.collectives_by_axis.setdefault(axis, {}).setdefault(
            kind, [0, 0])
        c[0] += calls
        c[1] += nbytes

    def numbers(self) -> dict:
        """Every count as a flat {name: int} (what ``combine`` adds)."""
        out = {"flops": self.flops, "bytes": self.bytes,
               "collective_bytes": self.collective_bytes,
               "transcendentals": self.transcendentals}
        for field in ("bytes_by_kind", "count_by_kind", "flops_by_dtype",
                      "kernels", "memory"):
            for k, v in getattr(self, field).items():
                out[(field, k)] = v
        for axis, kinds in self.collectives_by_axis.items():
            for kind, (calls, nbytes) in kinds.items():
                out[("axis", axis, kind, 0)] = calls
                out[("axis", axis, kind, 1)] = nbytes
        return out

    @classmethod
    def of(cls, numbers: dict) -> "CostTotals":
        t = cls(**{k: v for k, v in numbers.items() if isinstance(k, str)})
        for key, v in numbers.items():
            if isinstance(key, str):
                continue
            if key[0] == "axis":
                _, axis, kind, i = key
                t.collectives_by_axis.setdefault(axis, {}).setdefault(
                    kind, [0, 0])[i] = v
            else:
                getattr(t, key[0])[key[1]] = v
        return t


def combine(terms, den: int = 1) -> CostTotals:
    """sum(coef x totals) / den over ``terms`` ((int coefficient,
    CostTotals) pairs), every count; the division exact, or it raises."""
    acc: dict = {}
    for coef, t in terms:
        for k, v in t.numbers().items():
            acc[k] = acc.get(k, 0) + coef * v
    for k, v in acc.items():
        acc[k], r = divmod(v, den)
        if r:
            raise ArithmeticError(f"{k}: {v} / {den} is not exact")
    return CostTotals.of(acc)


def _grouped_mm_shape(a, b, offs) -> tuple:
    """``_grouped_mm``'s output shape (torch's meta rules)."""
    if a.dim() == 2 and b.dim() == 2:
        return (offs.shape[0], a.shape[0], b.shape[1])
    if a.dim() == 2:
        return (a.shape[0], b.shape[-1])
    if b.dim() == 2:
        return (a.shape[1], b.shape[1])
    return (a.shape[0], a.shape[1], b.shape[-1])


def _grouped_mm_flops(a, b, out) -> int:
    """2 x rows x d x f: the contracted dim is a's last, but for the 2D x
    2D form (a ragged contraction), whose groups partition it."""
    if a.dim() == 2 and b.dim() == 2:
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    return 2 * out.numel() * a.shape[-1]


class Counter(TorchDispatchMode):
    """The counting mode of one step on ``device`` (see the module's
    docstring). ``inputs``: the step's arguments, whose storages are not
    the step's allocations."""

    def __init__(self, device, inputs=(), profile_min: float | None = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.device = torch.device(device)
        self.totals = CostTotals()
        self.profile_min = profile_min
        self.paused = 0
        self.kinds: dict = {}
        self.inputs = {id(t.untyped_storage()): t.untyped_storage()
                       for t in tree_leaves(inputs) if torch.is_tensor(t)}
        self.held: dict[int, int] = {}
        self.live = self.peak = 0

    # -- memory -------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self.held.pop(key, 0)

    def _track(self, outs) -> None:
        for t in outs:
            if t.device != self.device:
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.held or key in self.inputs:
                continue
            n = st.nbytes()
            self.held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    # -- the kernels' entries (kernels/epilogue.py::_counted) ---------------
    @contextlib.contextmanager
    def kernel(self, name: str, work):
        flops, nbytes = work
        if not self.paused:
            for key, n in flops.items():
                self.totals.add_flops(key, n)
            self.totals.bytes += nbytes
            self.totals.kernels[name] = self.totals.kernels.get(name, 0) + 1
            self._profile(nbytes, "bytes", name, ())
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    # -- every aten op ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self.kinds.get(func) or self.kinds.setdefault(
            func, _classify(func, self.registry))
        if kind == "grouped" and args[0].device.type == "meta":
            a, b = args[0], args[1]
            out = torch.empty(_grouped_mm_shape(a, b, kwargs.get(
                "offs", args[2] if len(args) > 2 else None)),
                dtype=kwargs.get("out_dtype") or a.dtype, device=a.device)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        self._track(outs)
        if not self.paused and outs and kind != "free":
            self._count(func, kind, args, kwargs, out, outs)
        return out

    def _profile(self, cost, kind, op, shape) -> None:
        if self.profile_min is not None and cost >= self.profile_min:
            self.totals.profile.append((cost, kind, str(op), tuple(shape)))

    def _count(self, func, kind, args, kwargs, out, outs) -> None:
        ins = _tensors((args, kwargs))
        if not any(t.device == self.device for t in ins + outs):
            return
        t = self.totals
        first = outs[0]
        if kind == "grouped":
            n = _grouped_mm_flops(args[0], args[1], first)
            t.add_flops(_dtype_name(args[0].dtype), n)
            self._profile(n, "flops", func, first.shape)
        elif kind == "matmul":
            n = int(self.registry[func._overloadpacket](*args, **kwargs,
                                                         out_val=out))
            t.add_flops(_dtype_name(ins[0].dtype), n)
            self._profile(n, "flops", func, first.shape)
        elif kind in ("pointwise", "transcendental"):
            t.add_flops("vector", first.numel())
            if kind == "transcendental":
                t.transcendentals += first.numel()
        elif kind == "reduction":
            t.add_flops("vector", (ins[0] if ins else first).numel())
        reads = set(map(id, ins))
        if func._overloadpacket in _WRITE_ONLY:
            reads = set(map(id, _tensors(
                args[_WRITE_ONLY[func._overloadpacket]])))
        nbytes = sum(_nbytes(a) for a in {id(a): a for a in ins}.values()
                     if id(a) in reads) \
            + sum(_nbytes(o) for o in {id(o): o for o in outs}.values())
        t.bytes += nbytes
        self._profile(nbytes, "bytes", func, first.shape)


def _tensors(tree) -> list:
    """The tensors of an op's arguments or result (nested tuples, lists
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    items = tree.values() if isinstance(tree, dict) else tree \
        if isinstance(tree, (list, tuple)) else ()
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(_tensors(x))
    return out


def _classify(func, registry) -> str:
    """How an op counts: "free" (not aten, a view, allocation, metadata),
    "grouped" (``_grouped_mm``), "matmul" (torch's FLOP registry),
    "pointwise" / "transcendental", "reduction", or "other" (bytes
    only)."""
    packet = func._overloadpacket
    if func.namespace != "aten" or packet in _FREE or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns):
        return "free"
    if packet is _aten._grouped_mm:
        return "grouped"
    if packet in registry:
        return "matmul"
    if torch.Tag.pointwise in func.tags:
        return "transcendental" if packet in _TRANSCENDENTAL else "pointwise"
    if torch.Tag.reduction in func.tags or packet in _REDUCTIONS:
        return "reduction"
    return "other"


def _groups(mesh) -> list:
    """The mesh's collective counters (``parallel/tp.py``, ``dp.py``)."""
    if mesh is None:
        return []
    from repro_torch.parallel import dp, tp
    from repro_torch.parallel import partition as part
    out = []
    if part.mesh_shape(mesh).get("model", 1) > 1:
        out.append(tp.group_of(mesh))
    if dp.batch_ranks(mesh) > 1:
        out.append(dp.group_of(mesh))
    return out


def count_step(fn, *args, mesh=None, profile_min: float | None = None
               ) -> CostTotals:
    """Run ``fn(*args)`` once and count it (see the module's docstring);
    ``mesh``: the mesh whose collectives the step runs. The device is the
    first tensor argument's. ``profile_min``: keep a profile row for every
    op of at least that many bytes or FLOPs."""
    from repro_torch.kernels import epilogue
    device = next(t for t in tree_leaves(args) if torch.is_tensor(t)).device
    groups = _groups(mesh)
    for g in groups:
        g.reset()
    counter = Counter(device, args, profile_min)
    old, epilogue.COUNTER = epilogue.COUNTER, counter
    try:
        with counter:
            out = fn(*args)
    finally:
        epilogue.COUNTER = old
    t = counter.totals
    for g in groups:
        for (axis, kind), (calls, nbytes) in sorted(g.by_kind.items()):
            t.add_collective(axis, kind, calls, nbytes)
    fresh = aliased = 0
    seen = set()
    for o in tree_leaves(out):
        if not torch.is_tensor(o) or o.device != device:
            continue
        st = o.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        if id(st) in counter.inputs:
            aliased += st.nbytes()
        else:
            fresh += st.nbytes()
    t.memory = {"argument_bytes": sum(st.nbytes()
                                      for st in counter.inputs.values()),
                "output_bytes": fresh + aliased, "alias_bytes": aliased,
                "peak_bytes": counter.peak,
                "temp_bytes": counter.peak - fresh}
    t.profile.sort(key=lambda r: -r[0])
    return t


def _layer_kinds(cfg):
    """(counts, entries): how many layers run each distinct layer
    activation config, in order of first use, and that first layer's
    ``act_layers`` entry (None for a uniform model)."""
    acts = cfg.layer_activation_configs()
    kinds, counts, entries = [], [], []
    for i, a in enumerate(acts):
        if a in kinds:
            counts[kinds.index(a)] += 1
        else:
            kinds.append(a)
            counts.append(1)
            entries.append(cfg.act_layers[i] if cfg.act_layers else None)
    return counts, entries


def _with_layers(cfg, entries):
    n = len(entries)
    if cfg.act_layers:
        return dataclasses.replace(cfg, n_layers=n, act_layers=tuple(entries))
    return dataclasses.replace(cfg, n_layers=n)


# layers of a kind in the base count (a one-layer stack reshapes some
# stacked leaves as views that copy at two and more) and the short scans
# whose difference is a time step
BASE_LAYERS = 2
SCAN_TRIPS = (2, 3)
# (config name, layer activation configs) whose parameter caches on the
# meta device a count has filled (``count_cell``'s warm-up)
_WARM: set = set()


def _argument_bytes(args) -> int:
    storages = {id(a.untyped_storage()): a.untyped_storage()
                for a in tree_leaves(args) if torch.is_tensor(a)}
    return sum(st.nbytes() for st in storages.values())


def count_cell(cfg, shape, mesh, *, rules=None, hyper=None,
               whole: bool = False) -> CostTotals:
    """One rank's cost of a dry-run cell (``build_cell(cfg, shape,
    mesh)``'s step on its meta args), by the trip-count rule (see the
    module's docstring), or with ``whole`` by running every layer and time
    step. ``mesh`` must be a DeviceMesh over an initialised (fake) process
    group. The counts are warm: a small decode of the same model, its
    count dropped, fills the per-device parameter caches first (once a
    process and model).

    The memory is extrapolated alike where the trip-count rule applies,
    but a scan's live steps for one layer only (the backward of
    ``remat="block"`` keeps one layer's recompute at a time; a prefill
    drops each layer's steps), so it is an estimate (within 25% of the
    whole count on the smoke configs); ``argument_bytes`` is the whole
    cell's, exactly."""
    from repro_torch.launch import shapes as shp
    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.parallel import dp
    kw = {"rules": rules}
    if hyper is not None:
        kw["hyper"] = hyper

    def run(c, trips=None, cell=shape):
        fn, args = steps.build_cell(c, cell, mesh, **kw)
        fn.ready()
        old, layers.SCAN_TRIPS = layers.SCAN_TRIPS, trips
        try:
            return count_step(fn, *args, mesh=mesh)
        finally:
            layers.SCAN_TRIPS = old

    counts, entries = _layer_kinds(cfg)
    base_entries = [e for e, n in zip(entries, counts)
                    for _ in range(min(n, BASE_LAYERS))]
    warm = (cfg.name, cfg.layer_activation_configs())
    if warm not in _WARM:
        run(_with_layers(cfg, base_entries),
            cell=shp.ShapeCell("warm", 8, dp.batch_ranks(mesh), "decode"))
        _WARM.add(warm)
    if whole:
        return run(cfg)
    scan = shape.seq_len if (shape.kind != "decode" and (
        cfg.use_mamba or cfg.parallel_mamba)) else 1
    t0, t1 = SCAN_TRIPS if scan > SCAN_TRIPS[1] else (None, None)
    base = run(_with_layers(cfg, base_entries), t0)
    terms = [(1, base)]
    for k, n in enumerate(counts):
        if n > BASE_LAYERS:
            more = run(_with_layers(cfg, base_entries + [entries[k]]), t0)
            terms.append((n - BASE_LAYERS, combine([(1, more), (-1, base)])))
    mem_terms = list(terms)
    if t0 is not None:
        # one more step of each base layer: over their number, a layer's
        # time step, which every layer takes S - t0 more times
        longer = run(_with_layers(cfg, base_entries), t1)
        more_steps = combine([(1, longer), (-1, base)])
        terms.append((cfg.n_layers * (scan - t0),
                      combine([(1, more_steps)], den=len(base_entries))))
        mem_terms.append((scan - t0, more_steps))
    t = combine(terms)
    t.memory = combine(mem_terms).memory
    t.memory["argument_bytes"] = _argument_bytes(
        steps.build_cell(cfg, shape, mesh, **kw)[1])
    return t
