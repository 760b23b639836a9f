"""Export and serving of the engine's frame programs (port of
``structure_from_motion_tpu/serve.py``).

The pipeline is fixed-shape by design (every program's shapes follow from
``PipelineConfig``), so its device programs export with ``torch.export``:
:func:`export_engine` traces an engine's programs (frame step for both
frontends, keyframe assessment, eviction, reprojection metric, final BA)
and writes them with the config into one ``.npz`` artifact in the JAX
package's layout; :class:`ServedSfM` loads them into a drop-in engine that
never re-enters the Python geometry stack.

What an exported program holds: the ATen operators the stages run, the
hand-written kernels as ``sfm::*`` operators (``kernels.register_ops``),
the stage and bucket choices as ``cond`` nodes and the loops as tagged
``while_loop`` nodes (``utils/control.py``). At load, :func:`retarget_loops`
points each loop node at the live engine's loop (a fixed loop with no read,
a masked loop in chunks of CUDA graph replays), :func:`retarget_conds`
points each ``cond`` node at the live engine's switch (one host read
eagerly, IF nodes in a capture), :func:`hoist_constants` uploads the
constants the export left on the host once, and :func:`eager_calls`
points each ATen node it can at the eager binding the live engine calls.
A steady served frame (slot >= 2) is one ``control.graphed`` call of the
loaded program, as the live engine's steady frame is: on the card one CUDA
graph replay with no host read. An exported program takes its
random draws as inputs (``models.incremental.FrameDraws``): the served
engine draws them from the live engine's generators, every rung of the PnP
ladder a frame, so a served run repeats the live run's bits.

Artifacts are pinned to the device type they were exported on (the trace
bakes in the device of every constant); ``platforms`` in the artifact
says which, and :class:`ServedSfM` refuses another.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

from structure_from_motion_tpu_torch import kernels
from structure_from_motion_tpu_torch.config import PipelineConfig
from structure_from_motion_tpu_torch.utils import control

# 2: before a served steady frame is captured into a CUDA graph, every
# branch of the program's switches runs once on the live map, so each BA
# rung must clamp the map it is handed to its size
# (models/incremental._ba_rung); a version-1 program does not
_FORMAT_VERSION = 2


def enable_compilation_cache(cache_dir: str) -> None:
    """Keep this process's kernel builds in ``cache_dir``: the port compiles
    nothing but its kernels (``csrc/*.cu``, one library named by a hash of
    the sources), so a second process start with the same directory loads
    that library instead of running ``nvcc``. Builds nothing now."""
    path = Path(cache_dir).resolve()
    path.mkdir(parents=True, exist_ok=True)
    kernels.BUILD_DIR = path


def _flat(tree) -> list:
    """The tensor leaves of a structure of tensors, ``None`` and tuples."""
    return [t for t in torch.utils._pytree.tree_leaves(tree) if torch.is_tensor(t)]


class _Program(torch.nn.Module):
    """One engine program over a flat tuple of tensors: the ``SfMState``
    fields in order, then the program's other inputs; it returns the state
    fields (where it returns a state), then its other outputs."""

    def __init__(self, name: str, config: PipelineConfig, draws_like=None):
        super().__init__()
        self.name, self.config = name, config
        if draws_like is not None:
            from structure_from_motion_tpu_torch.utils.control import _split

            tensors, self.rebuild_draws = _split(draws_like)
            self.n_draws = len(tensors)

    def forward(self, *args):
        from structure_from_motion_tpu_torch.models import incremental as I
        from structure_from_motion_tpu_torch.models import tracks

        n = len(tracks.SfMState._fields)
        st, rest = tracks.SfMState(*args[:n]), args[n:]
        cfg, name = self.config, self.name
        if name in ("frame_step", "frame_step_native"):
            v, draws = rest[0], self.rebuild_draws(rest[1:1 + self.n_draws])
            inputs = rest[1 + self.n_draws:]
            fn = I._single_step if name == "frame_step" else I._frame_step_native
            st, info = fn(st, v, draws, *inputs, cfg)
            return (*st, *(info[k] for k in I.INFO_KEYS))
        if name == "assess":
            return I._assess_frame(st, *rest, cfg)
        if name == "assess_native":
            return I._assess_frame_native(st, *rest, cfg)
        if name == "evict":
            st, rec = tracks.evict_oldest_view(st)
            return (*st, *rec)
        if name == "reproj":
            return tracks.reprojection_error(st)
        if name == "finalize":  # the JAX package's 10 LM iterations
            st, *out = I._finalize_ba(st, 10, cfg)
            return (*st, *out)
        raise ValueError(f"unknown program {name!r}")


@contextlib.contextmanager
def _cached_type_hints():
    """Memoise ``typing.get_type_hints`` inside ``torch.export``'s
    deserializer while a program loads: it asks again for every node of
    the graph (most of a load's time); a schema class's hints never change."""
    from torch._export.serde import serialize

    real = getattr(serialize, "typing", None)
    if real is None or not hasattr(real, "get_type_hints"):
        yield
        return
    cache: dict = {}

    def hints(cls, *args, **kwargs):
        # the namespaces passed are module dicts: keyed by identity
        key = (cls, tuple(map(id, args)), tuple((k, id(v)) for k, v in sorted(kwargs.items())))
        if key not in cache:
            cache[key] = real.get_type_hints(cls, *args, **kwargs)
        return cache[key]

    proxy = type(real)("typing")
    proxy.__dict__.update(real.__dict__)
    proxy.get_type_hints = hints
    serialize.typing = proxy
    try:
        yield
    finally:
        serialize.typing = real


def _example_args(engine, draws) -> dict:
    """Fixed-shape example inputs of each program, at the engine's shapes
    and ``image_dtype`` (``draws``: a frame's :class:`FrameDraws`)."""
    cfg, st = engine.config, engine.state
    dev = st.points.device
    Kk, D = cfg.capacity.max_keypoints, cfg.frontend.descriptor_dim
    v = torch.zeros((), dtype=torch.long, device=dev)
    draws = _flat(draws)
    xy = torch.zeros((Kk, 2), device=dev)
    desc = torch.zeros((Kk, D), device=dev)
    valid = torch.zeros((Kk,), dtype=torch.bool, device=dev)
    img = torch.zeros(tuple(engine.image_shape), device=dev,
                      dtype=getattr(torch, np.dtype(engine.image_dtype).name))
    return {
        "frame_step": (*st, v, *draws, xy, desc, valid),
        "frame_step_native": (*st, v, *draws, img),
        "assess": (*st, v, xy, desc, valid),
        "assess_native": (*st, v, img),
        "evict": tuple(st),
        "reproj": tuple(st),
        "finalize": tuple(st),
    }


def export_program(module: torch.nn.Module, args: tuple) -> tuple:
    """``torch.export`` (non-strict) of ``module`` on ``args`` as an
    artifact holds it: every ``while_loop`` node tagged and no other node's
    ``meta["custom"]`` kept (the tracing context gives every node one; it
    would cost bytes and load time), no example inputs (a frame's draws
    alone are hundreds of MB at full width). Returns (serialized bytes,
    trace s, save s)."""
    t0 = time.perf_counter()
    with torch.no_grad(), control.export_tracing():
        ep = torch.export.export(module, args, strict=False)
    ep.example_inputs = None
    for _, gm in ep.graph_module.named_modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                tag = control.loop_tag(node.meta.pop("custom", None))
                if tag and node.target is torch.ops.higher_order.while_loop:
                    node.meta["custom"] = tag
    t1 = time.perf_counter()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), t1 - t0, time.perf_counter() - t1


def export_engine(engine, path: str, programs=None, stats: dict | None = None) -> dict:
    """Export ``engine``'s device programs and config to ``path``.

    ``engine``: an :class:`~structure_from_motion_tpu_torch.models.IncrementalSfM`;
    a native-frontend engine needs ``engine.image_shape = (H, W)`` (its
    frame program is shaped by the input image) and may set
    ``engine.image_dtype`` (default float32; ``np.uint8`` serves camera
    frames). ``programs``: the names to export (default: every program the
    engine's frontend and config use). Returns ``{name: serialized bytes}``;
    ``stats``, when given, receives ``{name: (trace s, save s)}``.
    """
    cfg = engine.config
    if cfg.ba_num_shards > 1:
        raise NotImplementedError("export of a sharded engine (ba_num_shards > 1) is not ported "
                                  "yet; see ROADMAP.md")
    native = engine.frontend == "native"
    if native and not hasattr(engine, "image_shape"):
        raise ValueError("set engine.image_shape = (H, W) before export_engine (the native frame "
                         "program is shaped by its input image)")
    if not hasattr(engine, "image_shape"):
        engine.image_shape = (1, 1)
    if not hasattr(engine, "image_dtype"):
        engine.image_dtype = np.float32
    if programs is None:
        programs = ["frame_step", "evict", "reproj", "finalize"]
        if native:
            programs.append("frame_step_native")
        if cfg.keyframe_min_flow_px > 0:
            programs.append("assess")
            if native:
                programs.append("assess_native")
    if not programs:
        raise ValueError("programs must name at least one program to export")
    draws_like = engine._draws(0).materialize(cfg)
    examples = _example_args(engine, draws_like)
    blobs, sizes = {}, {}
    for name in programs:
        prog = _Program(name, cfg, draws_like if name.startswith("frame_step") else None)
        blob, trace_s, save_s = export_program(prog, examples[name])
        if stats is not None:
            stats[name] = (trace_s, save_s)
        blobs[name] = np.frombuffer(blob, np.uint8)
        sizes[name] = len(blob)

    meta = {
        "format_version": _FORMAT_VERSION,
        "config": json.loads(cfg.to_json()),
        "frontend": engine.frontend,
        "image_shape": list(engine.image_shape),
        "image_dtype": np.dtype(engine.image_dtype).name,
        "programs": sorted(blobs),
        "platforms": [engine.state.points.device.type],
    }
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        __meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        __K=engine.state.K.cpu().numpy(),
        **{f"prog_{k}": v for k, v in blobs.items()},
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return sizes


def retarget_loops(module: torch.nn.Module, name: str = "program") -> int:
    """Run every ``while_loop`` node of a loaded program (``module`` and
    every graph under it: ``cond`` branches, loop bodies) as the live
    engine runs the loop its tag names (``utils/control.py``): a ``fori``
    node calls its body ``n`` times with no host read, a ``masked`` node
    runs its body in the live loop's chunks, one CUDA graph replay a chunk
    on the card. Raises ``ValueError`` on an untagged node (an artifact of
    an older export). Returns the number of nodes retargeted."""
    count = 0
    for path, gm in module.named_modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        found = False
        for node in gm.graph.nodes:
            if node.op != "call_function" or node.target is not torch.ops.higher_order.while_loop:
                continue
            tag = control.loop_tag(node.meta.get("custom")) or {}
            if tag.get("sfm_loop") == "masked":
                node.target, node.args = control.served_masked_loop, (*node.args, tag["n"],
                                                                       tag["k"])
            elif tag.get("sfm_loop") == "fori":
                node.target, node.args = control.served_fori, (*node.args, tag["n"])
            else:
                raise ValueError(f"{name}: the while_loop node {path or '<root>'}.{node.name} "
                                 "carries no loop tag: export the artifact again with this "
                                 "version's export_engine")
            found = True
            count += 1
        if found:
            gm.recompile()
    return count


def _cholesky_solve(*args, **kwargs):
    return control.unconditional(torch.ops.aten.cholesky_solve.default, *args, **kwargs)


# operators a CUDA graph's conditional body may not hold (cuSOLVER allocates
# in the stream), run outside the body as the live engine runs them
# (``ops/linalg.solve_psd``)
_UNCONDITIONAL = {torch.ops.aten.cholesky_solve.default: _cholesky_solve}


def retarget_conds(module: torch.nn.Module) -> int:
    """Run every ``cond`` node of a loaded program (``module`` and every
    graph under it) as the live engine's :func:`~.utils.control.switch`
    runs (``control.served_cond``): eagerly one host read and the branch it
    names, as torch's ``cond`` does; inside a CUDA graph capture an IF node
    a branch, decided on the device. Its Cholesky nodes run as the live
    engine's do (``control.unconditional``). Returns the number of ``cond``
    nodes retargeted."""
    count = 0
    for _, gm in module.named_modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        found = False
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            if node.target is torch.ops.higher_order.cond:
                node.target = control.served_cond
                count += 1
            elif node.target in _UNCONDITIONAL:
                node.target = _UNCONDITIONAL[node.target]
            else:
                continue
            found = True
        if found:
            gm.recompile()
    return count


_COPIES = {torch.ops.aten.to.device, torch.ops.aten.to.dtype_layout, torch.ops.aten.to.dtype,
           torch.ops.aten._to_copy.default}
# operators the export puts between a lifted constant and its use: each gives
# the constant's values again
_PURE = {torch.ops.aten.lift_fresh_copy.default, torch.ops.aten.detach_.default,
         torch.ops.aten.detach.default, torch.ops.aten.clone.default,
         torch.ops.aten.alias.default}


def _constant(gm: torch.fx.GraphModule, node):
    """The value of ``node`` when it is the program's own tensor (a
    ``get_attr``) or a copy or conversion of one (``_PURE`` and ``_COPIES``
    operators on it alone), computed now; else None."""
    if not isinstance(node, torch.fx.Node):
        return None
    if node.op == "get_attr":
        value = gm
        for part in node.target.split("."):
            value = getattr(value, part)
        return value if torch.is_tensor(value) else None
    if node.op != "call_function" or node.target not in _PURE | _COPIES or not node.args:
        return None
    if any(isinstance(a, torch.fx.Node) for a in (*node.args[1:], *node.kwargs.values())):
        return None
    src = _constant(gm, node.args[0])
    return None if src is None else node.target(src, *node.args[1:], **node.kwargs)


def hoist_constants(module: torch.nn.Module) -> int:
    """Replace every copy of a constant in a loaded program (``module`` and
    every graph under it: a ``to`` or ``_to_copy`` node whose input is the
    program's own tensor, through the export's ``lift_fresh_copy`` and
    ``detach_``) by its result, computed once here and kept as a buffer.
    The export lifts a constant the program builds on the card onto the
    host and copies it back at every run: on the card a host
    synchronisation a run, and an upload from pageable memory that no CUDA
    graph can hold. The copy of a constant is a constant: the bits are the
    node's. Returns the number of nodes replaced."""
    count = 0
    for _, gm in module.named_modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        found = False
        for node in list(gm.graph.nodes):
            if node.op != "call_function" or node.target not in _COPIES:
                continue
            value = _constant(gm, node)
            if value is None:
                continue
            name = f"_hoisted_{node.name}"
            gm.register_buffer(name, value)
            with gm.graph.inserting_before(node):
                const = gm.graph.get_attr(name)
            const.meta.update(node.meta)
            node.replace_all_uses_with(const)
            gm.graph.erase_node(node)
            found = True
            count += 1
        if found:
            gm.graph.eliminate_dead_code()
            gm.recompile()
    return count


def _eager_binding(op):
    """The eager binding the live engine calls for the ATen overload ``op``
    (``torch.<name>``, or the tensor method where the schema's first
    argument is ``self``), or None: for an operator that writes to an input,
    one without a binding of its name, or one whose name in the generated
    code would reach another function (``torch.einsum`` is a Python wrapper
    of the binding, with other arguments)."""
    schema = op._schema
    if op.namespace != "aten" or schema.is_mutable or op._opname.startswith("_"):
        return None
    fn = getattr(torch._C._VariableFunctions, op._opname, None)
    if fn is None and schema.arguments and schema.arguments[0].name == "self":
        fn = getattr(torch._C.TensorBase, op._opname, None)
    if fn is None:
        return None
    try:  # the name the generated code calls it by must be this very function
        module, _, attr = torch.fx.node._get_qualified_name(fn).rpartition(".")
        owner = importlib.import_module(module.split(".")[0])
        for part in module.split(".")[1:]:
            owner = getattr(owner, part)
        return fn if getattr(owner, attr) is fn else None
    except (AttributeError, ImportError, RuntimeError):
        return None


def _same_meta(got, want) -> bool:
    a, b = pytree.tree_leaves(got), pytree.tree_leaves(want)
    return len(a) == len(b) and all(
        torch.is_tensor(x) and torch.is_tensor(y) and x.shape == y.shape and x.dtype == y.dtype
        and x.stride() == y.stride() and x.device == y.device for x, y in zip(a, b))


def eager_calls(module: torch.nn.Module) -> int:
    """Point every ATen node of a loaded program (``module`` and every graph
    under it) at the operator's eager binding, the call the live engine
    makes: a loaded graph calls each operator through its ``OpOverload``,
    whose boxed call costs the host ~1-3 us more than the eager one
    (``tools/serve_frames.py`` measures both), and a frame runs thousands.
    The binding resolves the same overload from the same arguments, so the
    bits are the node's. A node is pointed only where the binding, run on
    the node's recorded fake inputs, gives its recorded output's shape,
    dtype, strides and device; every other node (an operator that writes to
    an input, one without a binding of its name, one whose binding gives
    another layout, and a copy between the host and the card: through
    ``Tensor.to`` it added a host synchronisation a frame on the card) keeps
    its ``OpOverload``. Returns the number of nodes pointed."""
    count = 0
    for _, gm in module.named_modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        changed = False
        for node in gm.graph.nodes:
            if node.op != "call_function" or not isinstance(node.target, torch._ops.OpOverload):
                continue
            fn = _eager_binding(node.target)
            want = node.meta.get("val")
            if fn is None or want is None:
                continue
            args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs),
                                                 lambda n: n.meta.get("val"))
            tensors = [t for t in pytree.tree_leaves((want, args, kwargs)) if torch.is_tensor(t)]
            fake = next((t.fake_mode for t in tensors if getattr(t, "fake_mode", None)), None)
            if fake is None or len({t.device for t in tensors}) > 1:
                continue
            try:
                with fake:
                    got = fn(*args, **kwargs)
            except Exception:  # the binding does not take this call: keep the node
                continue
            if _same_meta(got, want):
                node.target = fn
                changed = True
                count += 1
        if changed:
            gm.recompile()
    return count


class ServedSfM:
    """Drop-in engine backed by an artifact: the feeding API of
    :class:`~structure_from_motion_tpu_torch.models.IncrementalSfM`
    (``process_image`` / ``process_features`` / ``poses`` / ``map_points``
    / ``reprojection_error`` / ``finalize``), every device program a loaded
    ``torch.export`` program: the Python geometry stack is never entered.
    The window policy, archive and keyframe bookkeeping are the live
    engine's. ``device`` must be the device type the artifact was exported
    on. A steady frame is one CUDA graph replay on the card; its statistics
    stay on the device (no metric fetch), so the device's counts of the
    replays' conditional nodes (``utils/control.pending_counts``) are read
    once every 64 steady frames, one host read, unless the caller's
    ``device.fetch`` brings them first."""

    def __init__(self, path: str, seed: int = 0, device="cuda"):
        from structure_from_motion_tpu_torch.models import tracks
        from structure_from_motion_tpu_torch.models.incremental import INFO_KEYS, IncrementalSfM

        kernels.register_ops()  # the sfm:: operators the programs call
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta"]).decode())
            if meta["format_version"] != _FORMAT_VERSION:
                raise ValueError(f"artifact format {meta['format_version']} != "
                                 f"{_FORMAT_VERSION}: export the engine again")
            K = data["__K"]
            blobs = {name: bytes(data[f"prog_{name}"]) for name in meta["programs"]}
        dev = torch.device(device)
        if meta["platforms"] != [dev.type]:
            raise ValueError(f"the artifact was exported for {meta['platforms']}, not "
                             f"{dev.type!r}: export it again on the device that serves it")
        self.platforms = meta["platforms"]
        cfg = PipelineConfig.from_json(json.dumps(meta["config"]))
        with _cached_type_hints():
            self._modules = {name: torch.export.load(io.BytesIO(b)).module()
                             for name, b in blobs.items()}
        self.eager_nodes = {}  # program -> nodes pointed at their eager binding
        self.hoisted = {}  # program -> copies of constants computed at load
        for name, module in self._modules.items():
            retarget_loops(module, name)
            retarget_conds(module)
            self.hoisted[name] = hoist_constants(module)
            self.eager_nodes[name] = eager_calls(module)
        inner = IncrementalSfM(cfg, K, frontend=meta["frontend"], seed=seed,
                               collect_metrics=False, device=dev)
        inner.image_shape = tuple(meta["image_shape"])
        inner.image_dtype = np.dtype(meta.get("image_dtype", "float32"))
        n = len(tracks.SfMState._fields)
        m = self._modules
        slots: dict = {}
        graphs: dict = {}  # the steady frame's CUDA graphs, this engine's own

        def slot(v) -> torch.Tensor:  # one cached 0-dim tensor a slot, filled on the device
            if v not in slots:
                slots[v] = torch.full((), v, dtype=torch.long, device=dev)
            return slots[v]

        def state_in(st) -> list:
            return [t.contiguous() for t in st]

        image_dtype = getattr(torch, inner.image_dtype.name)

        def image(img):  # the programs are pinned to the exported image dtype
            if img.dtype != image_dtype:
                raise ValueError(f"the artifact takes {image_dtype} images, got {img.dtype} "
                                 "(export with engine.image_dtype set to the frames' type)")
            return img

        def frame(name):
            def run(st, v, draws, *inputs):
                if name == "frame_step_native":
                    inputs = (image(inputs[0]),)
                args = (*state_in(st), slot(v), *_flat(draws.materialize(cfg)), *inputs)
                # a steady frame: one graph replay, as the live engine's (frames 0
                # and 1 run the program as it is, as the live engine runs them)
                out = (control.graphed(m[name], *args, calls=graphs) if v >= 2
                       else m[name](*args))
                return tracks.SfMState(*out[:n]), dict(zip(INFO_KEYS, out[n:]))
            return run

        def evict(st):
            out = m["evict"](*state_in(st))
            return tracks.SfMState(*out[:n]), tracks.EvictionRecord(*out[n:])

        programs = inner.programs
        programs["frame_step"] = frame("frame_step")
        programs["evict"] = evict
        programs["reproj"] = lambda st: m["reproj"](*state_in(st))
        if "frame_step_native" in m:
            programs["frame_step_native"] = frame("frame_step_native")
        if "assess" in m:
            programs["assess"] = lambda st, prev, *f: m["assess"](*state_in(st), slot(prev), *f)
        if "assess_native" in m:
            programs["assess_native"] = lambda st, prev, img: m["assess_native"](
                *state_in(st), slot(prev), image(img))

        def finalize(st, iterations: int):
            if iterations != 10:
                raise ValueError("the exported finalize program is baked at 10 iterations")
            out = m["finalize"](*state_in(st))
            return (tracks.SfMState(*out[:n]), *out[n:])

        programs["finalize"] = finalize
        self._inner = inner

    # -- feeding / results: delegate to the inner engine -------------------
    def __getattr__(self, name):
        return getattr(self._inner, name)

    def finalize(self, iterations: int = 10):
        if iterations != 10:
            raise ValueError("the exported finalize program is baked at 10 iterations")
        return self._inner.finalize(iterations)


def load_engine(path: str, seed: int = 0, device="cuda") -> ServedSfM:
    """Load an :func:`export_engine` artifact into a served engine."""
    return ServedSfM(path, seed=seed, device=device)
