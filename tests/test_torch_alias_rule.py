"""A herculint rule for the port's host-to-device transfers, kept on the
test side (the port may not import ``repro.analysis``).

``torch.from_numpy(x)`` and ``torch.as_tensor(x)`` of a numpy array share
its memory, and ``t.pin_memory()`` of a tensor that is already pinned (a
reader slot) returns ``t`` itself: applied to a memory-mapped segment or a
reusable reader slot, the "copy" changes when the reader refills the slot
or the map is closed. herculint's ``alias-transfer`` covers the jax calls
only; this rule takes the same sources of taint
(``repro.analysis.rules.common.TaintTracker``: mmap loads, reader
``get()``, view-named values, through the project's helper summaries)
into those three torch calls. A transfer is safe when its result is
copied before anything else sees it: the call's result is the receiver of
``.clone()``, ``.to(..., copy=True)`` or ``.to("cuda...")``, or a name
whose every use is, or is ``.to(device)`` on the branch where
``device.type == "cpu"`` is false.

The port's sources must lint clean under it, with the project-wide
summary index, as ``tests/test_analysis.py`` lints the repository. Of the
sites it holds, ``data/pipeline.py::_owned_copy`` and ``storage/store.py``'s
journal copies take a view or a mapped segment and turn into findings when
their copy is taken out; ``_owned_cpu``, ``DoubleBufferedLoader._copy_to_device``
and ``reshard_checkpoint``'s placement take values with no taint the rule
can see and must stay clean (a mapped checkpoint's placement is checked at
run time). The port's modules must not change the taint summaries of the
JAX package's functions.
"""
import ast
import types
from pathlib import Path

import pytest

from repro.analysis import callgraph, herculint
from repro.analysis.rules.common import (
    RawFinding, TaintTracker, call_name, dotted, is_true_const, iter_scopes, kwarg,
)
from repro.analysis.rules.alias_transfer import _scope_statements, header_exprs
from _torch_threads import one_torch_thread  # noqa: F401

RULE_ID = "torch-alias-transfer"
ROOT = Path(__file__).resolve().parents[1]
SINKS = ("torch.from_numpy", "torch.as_tensor")


def _parents(scope) -> dict:
    out = {}
    for node in ast.walk(scope):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _cpu_test(test: ast.expr) -> str | None:
    """``D`` when ``test`` is ``D.type == "cpu"``."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.left, ast.Attribute) and test.left.attr == "type"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu"):
        return dotted(test.left.value)
    return None


def _copied(node: ast.expr, parents: dict) -> bool:
    """The value of ``node`` is copied before it is used: it is the
    receiver of ``.clone()`` / ``.to(..., copy=True)``, or of ``.to(D)``
    on the branch where ``D.type == "cpu"`` is false."""
    attr = parents.get(node)
    call = parents.get(attr)
    if not (isinstance(attr, ast.Attribute) and attr.value is node
            and isinstance(call, ast.Call) and call.func is attr):
        return False
    if attr.attr == "clone":
        return True
    if attr.attr != "to":
        return False
    if is_true_const(kwarg(call, "copy")):
        return True
    if (call.args and isinstance(call.args[0], ast.Constant)
            and str(call.args[0].value).startswith("cuda")):
        return True
    target = dotted(call.args[0]) if call.args else None
    child, up = call, parents.get(call)
    while up is not None:
        if isinstance(up, (ast.IfExp, ast.If)) and target and _cpu_test(up.test) == target:
            branch = up.orelse
            return child is branch or (isinstance(branch, list) and child in branch)
        child, up = up, parents.get(up)
    return False


def _safe(call: ast.Call, scope, parents: dict) -> bool:
    if _copied(call, parents):
        return True
    stmt = parents.get(call)
    if not (isinstance(stmt, ast.Assign) and stmt.value is call and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)):
        return False
    name = stmt.targets[0].id
    uses = [n for n in ast.walk(scope) if isinstance(n, ast.Name) and n.id == name
            and isinstance(n.ctx, ast.Load)]
    return bool(uses) and all(_copied(n, parents) for n in uses)


def check(tree, rel_path, src_lines, summaries=None):
    for scope in iter_scopes(tree):
        taint = TaintTracker(scope, summaries=summaries, path=rel_path)
        parents = _parents(scope)
        for stmt in _scope_statements(scope):
            for expr in header_exprs(stmt):
                for call in (n for n in ast.walk(expr) if isinstance(n, ast.Call)):
                    name = call_name(call)
                    if name in SINKS and call.args:
                        arg, what = call.args[0], name
                    elif isinstance(call.func, ast.Attribute) and call.func.attr == "pin_memory":
                        arg, what = call.func.value, "Tensor.pin_memory"
                    else:
                        continue
                    if taint.is_tainted(arg) and not _safe(call, scope, parents):
                        yield RawFinding(
                            RULE_ID, call.lineno, call.col_offset,
                            f"{what} of a possible mmap/slot view ({ast.unparse(arg)}) "
                            "shares its memory: copy it (np.array(view), .clone()) "
                            "before it leaves this scope")
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                taint.handle_for(stmt)
            else:
                taint.handle_assign(stmt)


RULE = types.SimpleNamespace(RULE_ID=RULE_ID, check=check)


@pytest.fixture(scope="module")
def project():
    sources = {p.resolve().relative_to(ROOT).as_posix(): p.read_text()
               for p in herculint.iter_python_files([ROOT / "src"])}
    return sources, callgraph.build_index(sources)


def _lint(source, rel, index):
    found, problems = herculint.lint_source(source, rel, rules=(RULE,), summaries=index)
    return found + problems


SEEDED = '''
import numpy as np
import torch


def staged(reader):
    return torch.from_numpy(reader.get())


def wrapped(slot_view):
    t = torch.as_tensor(slot_view)
    return t + 1


def pinned(slot):
    return slot.pin_memory()


def mapped(path):
    rows = np.load(path, mmap_mode="r")
    return torch.from_numpy(rows[:10])


def moved(view, device):
    host = torch.from_numpy(view)
    return host.to(device)


def fine(slot_view, device):
    a = torch.from_numpy(slot_view).clone()
    host = torch.from_numpy(slot_view)
    b = host.clone() if device.type == "cpu" else host.to(device)
    c = torch.as_tensor(slot_view).to(device, copy=True)
    d = torch.from_numpy(np.array(slot_view))
    e = torch.from_numpy(slot_view).to("cuda")
    return a, b, c, d, e
'''


def test_seeded_examples():
    found = _lint(SEEDED, "seeded.py", callgraph.AUTO)
    assert len(found) == 5
    assert {f.context for f in found} == {"staged", "wrapped", "pinned", "mapped", "moved"}
    assert all(f.rule == RULE_ID for f in found)


def test_the_port_lints_clean(project):
    sources, index = project
    found = [f for rel, src in sources.items() if rel.startswith("src/repro_torch/")
             for f in _lint(src, rel, index)]
    assert not found, "\n".join(f.format() for f in found)


# (file, the safe line, the same line with its copy taken out, scope): the
# sites where a mapped or view-named value reaches a transfer
HELD = [
    ("src/repro_torch/data/pipeline.py",
     "return host.clone() if device.type == \"cpu\" else host.to(device)",
     "return host.to(device)", "_owned_copy"),
    ("src/repro_torch/storage/store.py",
     "blk = torch.from_numpy(np.array(seg_rows[lo:lo + block])).to(q.device)",
     "blk = torch.from_numpy(seg_rows[lo:lo + block]).to(q.device)",
     "Hercules._merge_journal"),
]
# the sites whose inputs carry no taint the rule can see (a batch's leaves, a
# loaded checkpoint's arrays): they must be linted and stay clean
CLEAN = [
    ("src/repro_torch/data/pipeline.py", "_owned_cpu"),
    ("src/repro_torch/data/pipeline.py", "DoubleBufferedLoader._copy_to_device"),
    ("src/repro_torch/train/checkpoint.py", "reshard_checkpoint"),
    ("src/repro_torch/distributed/sharding.py", "NamedSharding.place"),
]


@pytest.mark.parametrize("rel,safe,unsafe,scope", HELD, ids=[h[3] for h in HELD])
def test_held_sites_turn_into_findings_without_their_copy(project, rel, safe, unsafe, scope):
    sources, index = project
    src = sources[rel]
    assert safe in src, f"{rel}: the held line moved"
    assert not [f for f in _lint(src, rel, index) if f.context == scope]
    found = [f for f in _lint(src.replace(safe, unsafe), rel, index) if f.context == scope]
    assert found, f"{scope} without its copy is not flagged"


@pytest.mark.parametrize("rel,scope", CLEAN, ids=[c[1] for c in CLEAN])
def test_clean_sites_are_linted(project, rel, scope):
    sources, index = project
    spans = herculint._qualname_index(ast.parse(sources[rel]))
    assert scope in spans.values(), f"{rel} has no {scope}"
    assert not [f for f in _lint(sources[rel], rel, index) if f.context == scope]


def test_reshard_of_a_mapped_checkpoint_owns_its_pieces(tmp_path):
    """A leaf that is a memory map is placed as copies: no piece, and no
    plain tensor, shares the map's memory."""
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import reshard_checkpoint

    arr = np.arange(64, dtype=np.float32).reshape(8, 8)
    np.save(tmp_path / "w.npy", arr)
    mapped = np.load(tmp_path / "w.npy", mmap_mode="r")
    mesh = make_host_mesh(2, devices=["cpu"] * 4)
    out = reshard_checkpoint({"w": mapped, "b": mapped[0]}, mesh,
                             lambda p, leaf: NamedSharding(mesh, P("data", "model"))
                             if p == "w" else None)
    for piece in out["w"].pieces.flat:
        assert not np.shares_memory(piece.numpy(), mapped)
    assert not np.shares_memory(out["b"].numpy(), mapped)
    assert torch.equal(out["w"].gather("cpu"), torch.from_numpy(arr))
    del mapped


def test_the_port_leaves_the_reference_summaries_alone(project):
    sources, index = project
    alone = callgraph.build_index({r: s for r, s in sources.items()
                                   if not r.startswith("src/repro_torch/")})
    ref = {k: (f.returns_tainted, f.returns_self_view, f.cleanses_return)
           for k, f in alone.functions.items()}
    both = {k: (f.returns_tainted, f.returns_self_view, f.cleanses_return)
            for k, f in index.functions.items() if k in ref}
    assert both == ref
