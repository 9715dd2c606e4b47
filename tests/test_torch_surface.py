"""The port's public surface against the JAX package's, read from source.

Both packages are parsed with ``ast`` and neither is imported, so this file
needs no JAX and no torch. Three checks, each parametrized so that a
failure names its module or case:

- every public top-level function and class of ``crnn_tpu/<m>.py``, and
  every public method of such a class, has a twin in
  ``crnn_tpu_torch/<m>.py`` (a method or class attribute may come from a
  base class of the port's twin);
- every parameter of a JAX function or method (``__init__`` and
  ``__call__`` included), and every field and class attribute of a JAX
  class, is accepted by the port's twin; a class attribute that JAX sets
  to a literal has the same literal in the port (``Solver.implicit``);
- every ``add_argument`` flag of a JAX case CLI (``crnn_tpu/cases/*.py``)
  is on the port's CLI of the same case.

Each exception is one entry of ``ALLOWED``, with its reason; ROADMAP.md
("Modules to port" and "Known divergences") gives the longer account. An
entry that no longer names a gap fails too, so the list cannot go stale.
"""

from __future__ import annotations

import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "crnn_tpu", "crnn_tpu_torch"

KEY = ("a torch.Generator takes the place of a JAX key "
       "(ROADMAP.md queue 1)")
MESH = ("the process group takes the place of a JAX mesh and axis name "
        "(ROADMAP.md queue 1)")
TPU_ONLY = ("TPU-only dispatch knob: a CUDA tensor takes the kernel, a CPU "
            "tensor its plain version, plain=True switches explicitly "
            "(ROADMAP.md queue 1)")
KNOB_DROPPED = ("a knob no caller set, dropped from the port "
                "(ROADMAP.md queue 1)")
S3 = ("the port's generate_dataset is the batch-major truth; JAX's "
      "generate_dataset is the port's generate_dataset_odesolve until "
      "ROADMAP.md queue 7 S3 merges them")

# "<module>:<name>" a missing function or class, "<module>:<Class>.<name>" a
# missing method or attribute, "<module>:<qualname>(<param>)" a parameter
ALLOWED = {
    "cases/case2.py:Case2Config.rhs_force": TPU_ONLY,
    "cases/cathode_uq.py:correlated_init(key)": KEY,
    "cases/robertson.py:RobertsonConfig.ub = None, not 10.0 as in crnn_tpu": (
        "the port's build clips y at ub, default inf; crnn_tpu ignores its "
        "field and clips at inf (crnn_tpu/cases/robertson.py:115), so the "
        "defaults agree in effect (ROADMAP.md known divergences)"),
    "data/reactions.py:ReactionNetwork.rhs(lb)": (
        "ignored in crnn_tpu as well: its RHS clips y at 0 whatever lb says "
        "(crnn_tpu/data/reactions.py:87-99; ROADMAP.md known divergences)"),
    "data/generate.py:latin_hypercube(key)": KEY,
    "data/generate.py:generate_dataset(key)": KEY,
    "data/generate.py:generate_dataset(solver)": S3,
    "data/generate.py:generate_dataset(scale_mode)": S3,
    "infra/metrics.py:MetricsLogger.__init__(print_every)": KNOB_DROPPED,
    "infra/plotting.py:plot_loss_curves(log_x)": KNOB_DROPPED,
    "infra/runtime.py:setup_cache": (
        "the JAX compilation cache; eager torch has none, and the kernels' "
        "build cache is ops/_build.py's (ROADMAP.md queue 1)"),
    "infra/runtime.py:enable_x64": (
        "torch dtypes are explicit per tensor; x64_scope covers the "
        "default dtype (ROADMAP.md queue 1)"),
    "infra/runtime.py:f64_device_ok": (
        "probes the TPU's emulated f64; the H100 runs f64 natively "
        "(ROADMAP.md queue 1)"),
    "models/mlp.py:mlp_init(key)": KEY,
    "models/mlp.py:make_mlp(key)": KEY,
    "ops/crnn_kernels.py:crnn_rhs_batched(force)": TPU_ONLY,
    "ops/crnn_kernels.py:crnn_rhs_batched(min_pallas_batch)": TPU_ONLY,
    "ops/crnn_kernels.py:crnn_rhs_jac_batched(force)": TPU_ONLY,
    "ops/crnn_kernels.py:crnn_rhs_jac_batched(min_pallas_batch)": TPU_ONLY,
    "ops/crnn_kernels.py:arrhenius_rhs_batched(force)": TPU_ONLY,
    "ops/crnn_kernels.py:arrhenius_rhs_batched(min_pallas_batch)": TPU_ONLY,
    "ops/crnn_kernels.py:arrhenius_rhs_jac_batched(force)": TPU_ONLY,
    "ops/crnn_kernels.py:arrhenius_rhs_jac_batched(min_pallas_batch)":
        TPU_ONLY,
    "ops/crnn_kernels.py:make_arrhenius_ops(force)": TPU_ONLY,
    "ops/crnn_kernels.py:make_crnn_rhs_op(force)": TPU_ONLY,
    "ops/crnn_kernels.py:make_crnn_rhs_jac_op(force)": TPU_ONLY,
    "ops/rb23_solve_kernel.py:make_arrhenius_fused_solve(interpret)":
        "Pallas interpret mode; on the CPU the plain version runs "
        "(ROADMAP.md queue 1)",
    "parallel/dp.py:make_dp_train_step(mesh)": MESH,
    "parallel/dp.py:make_dp_train_step(axis_name)": MESH,
    "parallel/dp.py:make_dp_eval(mesh)": MESH,
    "parallel/dp.py:make_dp_eval(axis_name)": MESH,
    "parallel/dp_runner.py:run_case_dp(n_devices)": (
        "a rank is not a device on the CPU: the gloo ranks run without a "
        "card, so the knob is n_ranks (ROADMAP.md known divergences)"),
    "parallel/mesh.py:make_mesh": MESH,
    "parallel/mesh.py:init_distributed(coordinator_address)": (
        "torch.distributed takes its address, size and rank from the "
        "environment (ROADMAP.md queue 1)"),
    "parallel/mesh.py:init_distributed(num_processes)": (
        "torch.distributed takes its address, size and rank from the "
        "environment (ROADMAP.md queue 1)"),
    "parallel/mesh.py:init_distributed(process_id)": (
        "torch.distributed takes its address, size and rank from the "
        "environment (ROADMAP.md queue 1)"),
    "parallel/svgd_dp.py:make_dp_svgd_step(value_and_grad_one)": (
        "the step scores a block of lanes (value_and_grad_lanes): the port "
        "has no vmap over the kernel ops (ROADMAP.md known divergences)"),
    "parallel/svgd_dp.py:make_dp_svgd_step(mesh)": MESH,
    "parallel/svgd_dp.py:make_dp_svgd_step(axis_name)": MESH,
    "train/loop.py:TrainState.key": KEY,
    "train/loop.py:Trainer.mode = 'batch', not 'sequential' as in crnn_tpu": (
        "every case passes mode=cfg.mode, so no case differs (ROADMAP.md "
        "known divergences)"),
    "transforms/p2vec.py:init_params_case1(key)": KEY,
    "transforms/p2vec.py:init_params_case2(key)": KEY,
    "transforms/p2vec.py:init_params_case3(key)": KEY,
    "transforms/p2vec.py:init_params_robertson(key)": KEY,
    "transforms/p2vec.py:init_params_reversible(key)": KEY,
    "transforms/p2vec.py:init_params_yeast(key)": KEY,
    "transforms/p2vec.py:init_params_cathode(key)": KEY,
}

MODULES = sorted(str(p.relative_to(ROOT / JAX_PKG))
                 for p in (ROOT / JAX_PKG).rglob("*.py"))
CASES = sorted(p.name for p in (ROOT / JAX_PKG / "cases").glob("*.py")
               if "add_argument" in p.read_text())


@functools.lru_cache(maxsize=None)
def _tree(pkg: str, module: str):
    path = ROOT / pkg / module
    return ast.parse(path.read_text()) if path.exists() else None


def _defs(tree) -> dict:
    """Top-level functions and classes, those under a top-level if/try
    included."""
    out = {}

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out[node.name] = node
            elif isinstance(node, (ast.If, ast.Try)):
                walk(node.body)
                walk(node.orelse)
                for handler in getattr(node, "handlers", ()):
                    walk(handler.body)
    walk(tree.body)
    return out


def _imported(tree) -> dict:
    """``from crnn_tpu_torch.<a>.<b> import X as Y`` -> {Y: (module, X)}."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == PORT_PKG):
            base = "/".join(node.module.split(".")[1:])
            if not base:
                module = "__init__.py"
            elif (ROOT / PORT_PKG / base).is_dir():
                module = f"{base}/__init__.py"
            else:
                module = f"{base}.py"
            for alias in node.names:
                out[alias.asname or alias.name] = (module, alias.name)
    return out


def _lookup(module: str, name: str):
    """The port's definition of ``name`` as seen from ``module``, through
    re-exports; None if it has none."""
    tree = _tree(PORT_PKG, module)
    if tree is None:
        return None
    node = _defs(tree).get(name)
    if node is not None:
        return module, node
    if name in _imported(tree):
        return _lookup(*_imported(tree)[name])
    return None


def _params(fn) -> tuple:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")], a.kwarg is not None


def _own_members(cls) -> tuple:
    """(methods {name: node}, attributes {name: literal value or None})."""
    methods, attrs = {}, {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[node.name] = node
        targets = ([node.target] if isinstance(node, ast.AnnAssign)
                   else node.targets if isinstance(node, ast.Assign) else [])
        value = getattr(node, "value", None)
        for target in targets:
            if isinstance(target, ast.Name):
                attrs[target.id] = (value.value
                                    if isinstance(value, ast.Constant)
                                    else None)
    return methods, attrs


def _members(module: str, cls) -> tuple:
    """The port class's methods and attributes, its bases' included (the
    nearest definition wins)."""
    methods, attrs = {}, {}
    for base in cls.bases:
        found = (_lookup(module, base.id) if isinstance(base, ast.Name)
                 else None)
        if found and isinstance(found[1], ast.ClassDef):
            base_methods, base_attrs = _members(*found)
            methods.update(base_methods)
            attrs.update(base_attrs)
    own_methods, own_attrs = _own_members(cls)
    methods.update(own_methods)
    attrs.update(own_attrs)
    return methods, attrs


def _missing_params(where: str, jfn, tfn) -> list:
    jparams, _ = _params(jfn)
    tparams, t_kwargs = _params(tfn)
    if t_kwargs:
        return []
    return [f"{where}({p})" for p in jparams if p not in tparams]


def _gaps(module: str) -> tuple:
    """(names without a twin, parameters/fields/attributes the twin does
    not accept or sets differently)."""
    jtree = _tree(JAX_PKG, module)
    if _tree(PORT_PKG, module) is None:
        return [f"{module}: no such module in {PORT_PKG}"], []
    names, params = [], []
    for name, jnode in _defs(jtree).items():
        if name.startswith("_"):
            continue
        found = _lookup(module, name)
        if found is None:
            names.append(f"{module}:{name}")
            continue
        tmodule, tnode = found
        if not isinstance(jnode, ast.ClassDef):
            if isinstance(tnode, ast.ClassDef):
                names.append(f"{module}:{name} (a class in the port)")
            else:
                params += _missing_params(f"{module}:{name}", jnode, tnode)
            continue
        if not isinstance(tnode, ast.ClassDef):
            names.append(f"{module}:{name} (not a class in the port)")
            continue
        jmethods, jattrs = _own_members(jnode)
        tmethods, tattrs = _members(tmodule, tnode)
        for m, jm in jmethods.items():
            if m.startswith("_") and m not in ("__init__", "__call__"):
                continue
            if m in tmethods:
                params += _missing_params(f"{module}:{name}.{m}", jm,
                                          tmethods[m])
            elif not m.startswith("_"):
                names.append(f"{module}:{name}.{m}")
        for attr, value in jattrs.items():
            if attr.startswith("_"):
                continue
            where = f"{module}:{name}.{attr}"
            if attr not in tattrs and attr not in tmethods:
                params.append(where)
            elif value is not None and tattrs.get(attr) != value:
                params.append(f"{where} = {tattrs.get(attr)!r}, "
                              f"not {value!r} as in {JAX_PKG}")
    return names, params


def _check(found: list, kind: str):
    gaps = [g for g in found if g not in ALLOWED]
    assert not gaps, f"{kind} of {JAX_PKG} with no twin in {PORT_PKG}: {gaps}"


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_twins(module):
    names, params = _gaps(module)
    _check(names, "public names")
    stale = {k for k in ALLOWED if k.startswith(f"{module}:")} \
        - set(names) - set(params)
    assert not stale, f"ALLOWED names no gap any more: {sorted(stale)}"


@pytest.mark.parametrize("module", MODULES)
def test_parameters_and_fields_are_accepted(module):
    _, params = _gaps(module)
    _check(params, "parameters, fields and attributes")


def _flags(tree) -> set:
    """Every option string passed to an ``add_argument`` call."""
    return {arg.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for arg in node.args
            if isinstance(arg, ast.Constant)
            and str(arg.value).startswith("-")}


@pytest.mark.parametrize("case", CASES)
def test_case_cli_flags_are_on_the_port(case):
    module = f"cases/{case}"
    want = _flags(_tree(JAX_PKG, module))
    assert want, f"{JAX_PKG}/{module} has no CLI flags"
    missing = sorted(want - _flags(_tree(PORT_PKG, module)))
    assert not missing, f"flags of {JAX_PKG}/{module} missing in the port: " \
        f"{missing}"
