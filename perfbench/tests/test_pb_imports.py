"""No module of the benchmark imports JAX, flax, optax or the JAX
package (top-level names compared whole, so the port, whose name begins
with the JAX package's, passes), and the reference imports nothing of
the port."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sdn3d_tpu"}
PORT = "sdn3d_tpu_torch"


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_walk_finds_the_benchmark():
    assert len(list(sources())) > 40


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    bad = FORBIDDEN.intersection(imported_tops(path))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(imported_tops(path)), path


def test_rule_compares_whole_names():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "sdn3d_tpu" in FORBIDDEN
