"""The port covers the JAX package, member for member, read from both
packages' sources with ``ast`` (neither package is imported).

For each ``src/repro/<path>.py`` the port's ``src/repro_torch/<path>.py``
must define, under the same name:

- every public module-level function and class;
- every public method or property of those classes, and ``__init__``;
- every field of a class body (a dataclass's or a NamedTuple's);
- for each function and method, at least JAX's parameter names, less
  those in ``JAX_ARGS`` (PRNG keys: the port seeds with ints; the mesh a
  JAX function reads from its context; the Pallas / jit / interpret-mode
  switches).

A package ``__init__`` re-exports every name JAX's does (imported eagerly,
defined, or named in a table of lazy imports).

What the port leaves out on purpose is listed in ``JAX_ONLY``, keyed
``"path:qualname"`` (a member) or ``"path:qualname(param)"`` (one
parameter).  Each value is a port counterpart, ``"→ path:qualname"`` in
``src/repro_torch/`` followed by a note, or a reason.  An entry that names
what JAX no longer has, or what the port now has, fails: the table cannot
rot."""
import ast
import pathlib
import re

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JAX_PKG, PORT_PKG = SRC / "repro", SRC / "repro_torch"

JAX_ARGS = frozenset({"self", "cls", "key", "rng", "mesh", "use_pallas",
                      "jit", "interpret"})

_XLA = "no counterpart: JAX/XLA machinery"

JAX_ONLY = {
    # JAX dtype accessor
    "configs/base.py:ModelConfig.jnp_dtype":
        "→ configs/base.py:ModelConfig.torch_dtype",
    # Pallas entry points
    "kernels/decode_attention.py:decode_attention_pallas":
        "→ kernels/decode_attention.py:decode_attention_cuda "
        "(csrc/decode_attention.cu, dispatched by kernels/ops.py)",
    "kernels/grouped_ffn.py:grouped_ffn_pallas":
        "→ kernels/grouped_ffn.py:grouped_ffn_cuda (csrc/grouped_ffn.cu)",
    "kernels/ssm_scan.py:ssm_scan_pallas":
        "→ kernels/ssm_scan.py:ssm_scan_cuda (csrc/ssm_scan.cu)",
    "kernels/masked_compact.py:masked_compact_pallas":
        "→ kernels/masked_compact.py:masked_compact_cuda "
        "(csrc/masked_compact.cu)",
    # interpret-mode switches
    "kernels/decode_attention.py:auto_interpret":
        f"{_XLA}: Pallas interpret mode; a port wrapper takes its plain "
        "version on CPU tensors",
    "kernels/ops.py:default_interpret":
        f"{_XLA}: the REPRO_PALLAS_INTERPRET override of interpret mode",
    "serving/engine.py:resolve_use_pallas":
        "→ kernels/ops.py:resolve_use_kernels (kernels on a CUDA or meta "
        "device)",
    # XLA lowering: the port counts on the meta device
    "launch/dryrun.py:lower_one":
        "→ launch/dryrun.py:trace_one (traces on the meta device)",
    "launch/dryrun.py:analyse":
        "→ serving/profiling.py:measure (flops, bytes, collectives, memory)",
    "launch/roofline.py:lower_block_cost":
        "→ launch/roofline.py:block_cost",
    "serving/profiling.py:collective_bytes":
        "→ distributed/collectives.py:CollectiveCounter (counts each "
        "collective as it is issued, not from HLO text)",
    "serving/profiling.py:analyse_compiled":
        "→ serving/profiling.py:measure",
    # sharding helpers
    "launch/mesh.py:params_shardings":
        "→ launch/mesh.py:params_specs (placements, not NamedShardings)",
    "launch/mesh.py:data_shardings": "→ launch/mesh.py:data_specs",
    "launch/mesh.py:replicated":
        f"{_XLA}: a replicated NamedSharding; a port tensor is whole on "
        "every rank unless cut",
    "launch/train.py:build_mesh":
        "→ launch/train.py:build_mesh_shape (the shape; the ranks come from "
        "torch.distributed)",
    "models/sharding.py:replicated_sharding":
        f"{_XLA}: the NamedSharding of carried decode state",
    "models/sharding.py:put_replicated":
        "→ models/sharding.py:replicate",
    "models/sharding.py:shard_map_compat":
        f"{_XLA}: dispatch between jax.shard_map versions",
    "models/sharding.py:constrain":
        f"{_XLA}: with_sharding_constraint; the port cuts tensors itself",
    # scaleout_mesh's parameter
    "models/sharding.py:scaleout_mesh(devices)":
        "→ models/sharding.py:scaleout_mesh (takes ranks= in place of JAX "
        "devices)",
    # init functions
    "models/layers.py:mlp_init": "→ models/model.py:init_params",
    "models/layers.py:embed_init": "→ models/model.py:init_params",
    "models/transformer.py:init_block": "→ models/model.py:init_params",
    # moved helper
    "models/attention.py:decode_attention_ref":
        "→ kernels/ref.py:decode_attention_ref",
}


def _statements(body):
    """A body's statements, looking through module-level if / try."""
    for s in body:
        if isinstance(s, ast.If):
            yield from _statements(s.body)
            yield from _statements(s.orelse)
        elif isinstance(s, ast.Try):
            for b in (s.body, s.orelse, s.finalbody,
                      *(h.body for h in s.handlers)):
                yield from _statements(b)
        else:
            yield s


def _params(fn):
    a = fn.args
    return tuple(x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs))


def members(source):
    """{qualname: parameter names (a function) or None (a class or a
    field)} of a module's public surface."""
    out = {}

    def visit(body, prefix, in_class):
        for s in _statements(body):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not s.name.startswith("_") or (in_class
                                                  and s.name == "__init__"):
                    out[prefix + s.name] = _params(s)
            elif isinstance(s, ast.ClassDef) and not s.name.startswith("_"):
                out[prefix + s.name] = None
                visit(s.body, f"{prefix}{s.name}.", True)
            elif (in_class and isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)
                  and not s.target.id.startswith("_")):
                out[prefix + s.target.id] = None

    visit(ast.parse(source).body, "", False)
    return out


def gaps(rel, jax_source, port_source):
    """What the port's module lacks of JAX's, less ``JAX_ONLY``."""
    have = members(port_source)
    out = []
    for q, params in members(jax_source).items():
        if f"{rel}:{q}" in JAX_ONLY:
            continue
        if q not in have:
            out.append(f"{rel}:{q}")
            continue
        for p in params or ():
            if (p not in JAX_ARGS and p not in (have[q] or ())
                    and f"{rel}:{q}({p})" not in JAX_ONLY):
                out.append(f"{rel}:{q}({p})")
    return out


def exports(source):
    """Public names a package ``__init__`` binds: imported, defined,
    assigned, or named as a string (a table of lazy imports)."""
    out = set()
    for s in ast.walk(ast.parse(source)):
        if isinstance(s, ast.ImportFrom):
            out |= {a.asname or a.name for a in s.names}
        elif isinstance(s, (ast.FunctionDef, ast.ClassDef)):
            out.add(s.name)
        elif isinstance(s, ast.Assign):
            out |= {t.id for t in s.targets if isinstance(t, ast.Name)}
        elif isinstance(s, ast.Constant) and isinstance(s.value, str) \
                and s.value.isidentifier():
            out.add(s.value)
    return {n for n in out if not n.startswith("_")}


def _read(pkg, rel):
    path = pkg / rel
    return path.read_text() if path.exists() else None


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))
JAX_INITS = [m for m in JAX_MODULES if m.endswith("__init__.py")]


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_module_covers_jax(rel):
    port = _read(PORT_PKG, rel)
    assert port is not None, f"no src/repro_torch/{rel}"
    assert gaps(rel, _read(JAX_PKG, rel), port) == []


@pytest.mark.parametrize("rel", JAX_INITS)
def test_port_package_reexports_jax(rel):
    missing = sorted(exports(_read(JAX_PKG, rel))
                     - exports(_read(PORT_PKG, rel)))
    assert missing == [], f"src/repro_torch/{rel} does not export {missing}"


_KEY = re.compile(r"^(?P<rel>[\w/]+\.py):(?P<q>[\w.]+)(?:\((?P<p>\w+)\))?$")
_POINTER = re.compile(r"^→ (?P<rel>[\w/]+\.py):(?P<q>[\w.]+)(?: \(.+\))?$")


def test_jax_only_entries_hold():
    """Every entry names a JAX member (or parameter) that the port still
    lacks, and gives a port counterpart that exists, or a reason."""
    for key, why in JAX_ONLY.items():
        m = _KEY.match(key)
        assert m, f"malformed key {key!r}"
        rel, q, p = m["rel"], m["q"], m["p"]
        want = members(_read(JAX_PKG, rel) or "")
        assert q in want, f"{key}: JAX has no {q} in {rel} any more"
        port = _read(PORT_PKG, rel)
        have = members(port) if port is not None else {}
        if p is None:
            assert q not in have, f"{key}: the port has it now; drop the entry"
        else:
            assert p in (want[q] or ()), f"{key}: JAX's {q} takes no {p}"
            assert q in have and p not in (have[q] or ()), \
                f"{key}: the port's {q} takes {p} now; drop the entry"
        ptr = _POINTER.match(why)
        if why.startswith("→"):
            assert ptr, f"{key}: malformed pointer {why!r}"
            target = _read(PORT_PKG, ptr["rel"])
            assert target is not None and ptr["q"] in members(target), \
                f"{key}: the port has no {ptr['rel']}:{ptr['q']}"
        else:
            assert len(why.split()) >= 4, f"{key}: give a reason, not {why!r}"


def _drop(source, qualname):
    """The source with one definition (a.b) removed."""
    tree = ast.parse(source)
    *outer, name = qualname.split(".")
    body = tree.body
    for part in outer:
        body = next(s for s in _statements(body)
                    if isinstance(s, ast.ClassDef) and s.name == part).body
    hit = [s for s in body if getattr(s, "name", None) == name
           or (isinstance(s, ast.AnnAssign)
               and getattr(s.target, "id", None) == name)]
    assert len(hit) == 1, qualname
    body.remove(hit[0])
    return ast.unparse(tree)


def _drop_param(source, fn, param):
    """The source with one parameter of function ``fn`` removed."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == fn:
            a = node.args
            for lst, defaults in ((a.args, a.defaults),
                                  (a.kwonlyargs, a.kw_defaults)):
                names = [x.arg for x in lst]
                if param in names:
                    i = names.index(param)
                    lst.pop(i)
                    if lst is a.kwonlyargs:
                        defaults.pop(i)
                    elif i >= len(names) - len(defaults):
                        defaults.pop(i - (len(names) - len(defaults)))
                    return ast.unparse(tree)
    raise AssertionError(f"{fn} takes no {param}")


@pytest.mark.parametrize("rel,mutate,want", [
    ("core/offload.py", lambda s: _drop(s, "OffloadEngine.auxiliary"),
     "core/offload.py:OffloadEngine.auxiliary"),
    ("configs/base.py", lambda s: _drop(s, "ModelConfig.param_count"),
     "configs/base.py:ModelConfig.param_count"),
    ("core/solver.py", lambda s: _drop(s, "SolverConstraints.r_min"),
     "core/solver.py:SolverConstraints.r_min"),
    ("core/solver.py", lambda s: _drop(s, "solve_split_ratio"),
     "core/solver.py:solve_split_ratio"),
    ("core/solver.py",
     lambda s: _drop_param(s, "solve_joint", "accuracy_per_drop"),
     "core/solver.py:solve_joint(accuracy_per_drop)"),
], ids=["property", "method", "field", "function", "keyword"])
def test_walk_catches_a_removed_twin(rel, mutate, want):
    """The port's own module with one twin (or one keyword) removed in
    memory shows exactly that gap."""
    port = _read(PORT_PKG, rel)
    assert gaps(rel, _read(JAX_PKG, rel), port) == []
    assert gaps(rel, _read(JAX_PKG, rel), mutate(port)) == [want]
