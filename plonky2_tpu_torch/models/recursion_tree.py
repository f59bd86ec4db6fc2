"""A tree of recursive proofs (tests/test_tree_recursion.py:24-61 of the
JAX package): the inner Fibonacci circuit (models/fibonacci.py), the
shared common data ``common_data_for_recursion(config, 5, 2)``, the leaf
circuit over the inner proof and the node circuit over two proofs of the
common data (plonk/tree_recursion.py).

``build_tree`` and ``tree_witnesses`` take the builder, the witness class
and the functions of either package, so that the JAX package builds the
same tree (the tests hold the two against each other);
``build_tree_circuits`` builds it with the port's.
"""
from __future__ import annotations

from ..iop.witness import PartialWitness
from ..plonk import tree_recursion
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..plonk.recursion import common_data_for_recursion
from .fibonacci import build_fibonacci_circuit


def _run(name, make):
    return make()


def build_tree(builder_cls, config, fibonacci, common_data, build,
               stage=_run) -> dict:
    """The tree's circuits under `config`: `fibonacci(config)` gives the
    inner circuit's (data, witness, public inputs), `common_data` is the
    package's common_data_for_recursion and `build(builder)` builds a
    circuit.  `stage(name, make)` runs each of the four builds ("inner",
    "common data", "leaf", "node"; a timer may wrap them).  Returns the
    inner circuit's data and witness, the shared common data, and the
    leaf and node circuits with their targets."""
    inner, inner_pw, _ = stage("inner", lambda: fibonacci(config))
    common = stage("common data", lambda: common_data(config, 5, 2))

    def circuit(add):
        b = builder_cls(config)
        targets = add(b)
        return build(b), targets

    leaf, leaf_t = stage("leaf", lambda: circuit(
        lambda b: b.tree_recursion_leaf(inner.common, common)))
    node, node_t = stage("node", lambda: circuit(
        lambda b: b.tree_recursion_node(common)))
    return dict(inner=inner, inner_pw=inner_pw, common=common, leaf=leaf,
                leaf_t=leaf_t, node=node, node_t=node_t)


def build_tree_circuits(config: CircuitConfig | None = None, device=None,
                        stage=_run) -> dict:
    """build_tree with the port's builder under `config` (default
    standard_recursion_config), each circuit built on `device` (default
    cuda)."""
    config = config or CircuitConfig.standard_recursion_config()
    return build_tree(
        CircuitBuilder, config,
        lambda c: build_fibonacci_circuit(c, device=device),
        common_data_for_recursion, lambda b: b.build(device=device), stage)


def tree_witnesses(tree: dict, inner_proof, pw_cls=PartialWitness,
                   tr=tree_recursion):
    """The tree's witnesses, of `pw_cls` through the package's
    tree_recursion module `tr`: leaf() -> the leaf's over the inner
    proof, node(p0, p1) -> the node's over two proofs."""
    def leaf_pw():
        pw = pw_cls()
        tr.set_tree_recursion_leaf_data(pw, tree["leaf_t"], inner_proof,
                                        tree["inner"].verifier_only,
                                        tree["leaf"].verifier_only)
        return pw

    def node_pw(p0, p1):
        pw = pw_cls()
        tr.set_tree_recursion_node_data(pw, tree["node_t"], p0, p1,
                                        tree["node"].verifier_only)
        return pw
    return leaf_pw, node_pw
