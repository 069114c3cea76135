"""The port's surface against the JAX package's, module by module.

Every module of ``aerial_mapper_tpu/`` is parsed with ``ast`` (nothing is
imported), and so is its twin under ``aerial_mapper_tpu_torch/``. Each
module must have its twin file; each public top-level function and class,
and each public method, must have a twin of the same name; and each
parameter name of a public JAX function or method, and each field of a
public JAX class, must appear in the twin. The deliberate differences are
the entries of the table below, each with its reason; an entry that no
longer names a real difference fails too, so the table cannot outlive the
code it excuses.
"""

import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "aerial_mapper_tpu"
PORT_PKG = "aerial_mapper_tpu_torch"

# ---- the deliberate differences, each with its reason ----

# module -> its twin under another name: the Pallas kernels' files are
# replaced by the CUDA kernels' wrappers, and each public ``*_pallas``
# function by its ``*_cuda`` twin. Their parameters are not compared: the
# wrappers take the CUDA kernels' operands (a packed camera bank, an SGM
# config), not the Pallas grids' (tile sizes, ``interpret``).
RENAMED_MODULES = {
    "stereo/pallas_bm.py": "stereo/cuda_bm.py",
    "stereo/pallas_sgm.py": "stereo/cuda_sgm.py",
    "dsm/pallas_idw.py": "dsm/cuda_idw.py",
    "ortho/pallas_score.py": "ortho/cuda_score.py",
}
# module prefixes with no twin
UNPORTED_PREFIXES = {
    "testing/": "test oracles (the numpy reference, the CPU pipeline): the "
                "port's tests use them from the JAX package, and only tests "
                "import both packages",
}
# parameter names a twin may lack anywhere
PARAMS_WITHOUT_TWIN = {
    "interpret": "Pallas interpret mode, a TPU compile switch",
    "scan_unroll": "lax.scan's unroll factor, a TPU compile switch (the "
                   "port's configs keep the field for parity)",
}
# (module, name) -> why the public name has no twin
NAMES_WITHOUT_TWIN = {
    ("utils/timing.py", "block_until_ready_tree"):
        "blocks on each array of a pytree; one torch.cuda.synchronize "
        "waits for a whole device (StageTimer.time_fn does it)",
    ("mapgrid/grid.py", "MapState"):
        "a NamedTuple that makes the layers a pytree; the port's "
        "create_map_state returns the layer dict every port caller uses",
}
# (module, function) -> its parameters that the twin names otherwise
SHARDED_LIST_PARAMS = {
    ("parallel/halo.py", "halo_exchange_rows"): {"local"},
    ("parallel/halo.py", "halo_exchange_extended"): {"ext"},
    ("parallel/distributed.py", "gather_row_bands_to_host"): {"array"},
}
SHARDED_LIST_REASON = (
    "JAX takes one global array inside shard_map; the port takes the list "
    "of shards (a mesh's bands, None where another rank holds one)")


def _jax_modules():
    base = os.path.join(ROOT, JAX_PKG)
    out = []
    for root, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), base)
                           .replace(os.sep, "/"))
    return sorted(out)


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


def _surface(path) -> dict:
    """name -> ("function", params) or ("class", fields, {method: params})
    for the public top-level functions and classes of one file."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = {}
    for node in tree.body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("function", _params(node))
        elif isinstance(node, ast.ClassDef):
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            methods = {m.name: _params(m) for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and not m.name.startswith("_")}
            out[node.name] = ("class", fields, methods)
    return out


def _missing(want, have) -> set:
    return {p for p in want if p not in have and p not in PARAMS_WITHOUT_TWIN}


def _differences(module: str) -> list:
    """What of ``module``'s public surface the port lacks, table applied."""
    twin = RENAMED_MODULES.get(module, module)
    jax_path = os.path.join(ROOT, JAX_PKG, module)
    port_path = os.path.join(ROOT, PORT_PKG, twin)
    if not os.path.exists(port_path):
        return [f"no twin file {PORT_PKG}/{twin}"]
    renamed = module in RENAMED_MODULES
    port = _surface(port_path)
    out = []
    for name, entry in _surface(jax_path).items():
        if (module, name) in NAMES_WITHOUT_TWIN:
            continue
        twin_name = name.replace("_pallas", "_cuda") if renamed else name
        got = port.get(twin_name)
        if got is None or got[0] != entry[0]:
            out.append(f"{entry[0]} {name}: no twin {twin_name}")
            continue
        if entry[0] == "function":
            if renamed:
                continue
            miss = _missing(entry[1], got[1])
            if miss != SHARDED_LIST_PARAMS.get((module, name), set()):
                out.append(f"{name}: parameters {sorted(miss)} missing")
            continue
        miss = _missing(entry[1], got[1])
        if miss:
            out.append(f"class {name}: fields {sorted(miss)} missing")
        for meth, params in entry[2].items():
            if meth not in got[2]:
                out.append(f"{name}.{meth}: no twin")
            elif _missing(params, got[2][meth]):
                out.append(f"{name}.{meth}: parameters "
                           f"{sorted(_missing(params, got[2][meth]))} "
                           f"missing")
    return out


MODULES = _jax_modules()


@pytest.mark.parametrize("module", MODULES)
def test_module_has_its_twin(module):
    if any(module.startswith(p) for p in UNPORTED_PREFIXES):
        assert not os.path.exists(os.path.join(ROOT, PORT_PKG, module))
        return
    assert _differences(module) == []


def test_table_names_only_real_differences():
    """Every entry of the table excuses a difference that exists: its JAX
    name is there and its twin is not, its parameters are missing from the
    twin, its renamed file replaces a JAX file that the port has no copy
    of, and every reason is given."""
    for module, name in NAMES_WITHOUT_TWIN:
        assert name in _surface(os.path.join(ROOT, JAX_PKG, module))
        assert name not in _surface(os.path.join(ROOT, PORT_PKG, module))
    for (module, name), params in SHARDED_LIST_PARAMS.items():
        want = _surface(os.path.join(ROOT, JAX_PKG, module))[name][1]
        have = _surface(os.path.join(ROOT, PORT_PKG, module))[name][1]
        assert params == set(want) - set(have), (module, name)
    for module, twin in RENAMED_MODULES.items():
        assert module in MODULES
        assert not os.path.exists(os.path.join(ROOT, PORT_PKG, module))
        assert os.path.exists(os.path.join(ROOT, PORT_PKG, twin))
    for prefix in UNPORTED_PREFIXES:
        assert any(m.startswith(prefix) for m in MODULES)
    used = set()
    for module in MODULES:
        for entry in _surface(os.path.join(ROOT, JAX_PKG, module)).values():
            used.update(entry[1])
            if entry[0] == "class":
                for params in entry[2].values():
                    used.update(params)
    assert set(PARAMS_WITHOUT_TWIN) <= used
    reasons = [*UNPORTED_PREFIXES.values(), *PARAMS_WITHOUT_TWIN.values(),
               *NAMES_WITHOUT_TWIN.values(), SHARDED_LIST_REASON]
    assert all(len(r) > 20 for r in reasons)


def test_surface_check_catches_a_missing_name(tmp_path, monkeypatch):
    """The check fails when a twin loses a public function, a parameter or
    its file: run on a copy of one port module with each removed."""
    module = "image/sample.py"
    for sub in (JAX_PKG, PORT_PKG):
        os.makedirs(tmp_path / sub / "image")
    with open(os.path.join(ROOT, JAX_PKG, module)) as f:
        (tmp_path / JAX_PKG / module).write_text(f.read())
    with open(os.path.join(ROOT, PORT_PKG, module)) as f:
        port_src = f.read()
    monkeypatch.setattr(sys.modules[__name__], "ROOT", str(tmp_path))
    (tmp_path / PORT_PKG / module).write_text(port_src)
    assert _differences(module) == []
    (tmp_path / PORT_PKG / module).write_text(
        port_src.replace("def nearest_sample(", "def nearest_sample_(", 1))
    assert _differences(module) == ["function nearest_sample: no twin "
                                    "nearest_sample"]
    (tmp_path / PORT_PKG / module).write_text(
        port_src.replace("nearest: bool = False) -> torch.Tensor:\n"
                         '    """cv::remap', ") -> torch.Tensor:\n"
                         '    """cv::remap', 1))
    assert _differences(module) == ["remap: parameters ['nearest'] missing"]
    os.remove(tmp_path / PORT_PKG / module)
    assert _differences(module) == [f"no twin file {PORT_PKG}/{module}"]
