"""Golden-value and property tests for the scenario tree layer.

Mirrors the reference test strategy (tests/test_scenario_tree.py): exact node
counts, ancestors, stages, probabilities, w-values for a fixed 3-state Markov
chain, plus randomized conditional-probability checks, plus the index plans
the batched device kernels rely on.
"""

import numpy as np
import pytest

from raocp_tpu import MarkovChainScenarioTreeFactory


@pytest.fixture(scope="module")
def golden_tree():
    p = np.array([[0.1, 0.8, 0.1],
                  [0.4, 0.6, 0.0],
                  [0.0, 0.3, 0.7]])
    v = np.array([0.5, 0.5, 0.0])
    return MarkovChainScenarioTreeFactory(p, v, 4, 3).create()


def test_num_nodes(golden_tree):
    assert golden_tree.num_nodes == 32


def test_num_nonleaf_nodes(golden_tree):
    assert golden_tree.num_nonleaf_nodes == 20


def test_num_stages(golden_tree):
    assert golden_tree.num_stages == 5


def test_ancestors(golden_tree):
    t = golden_tree
    assert t.ancestor_of(1) == 0 and t.ancestor_of(2) == 0
    assert t.ancestor_of(3) == 1 and t.ancestor_of(4) == 1
    assert t.ancestor_of(5) == 1
    assert t.ancestor_of(6) == 2 and t.ancestor_of(7) == 2
    assert t.ancestor_of(8) == 3 and t.ancestor_of(9) == 3
    assert t.ancestor_of(10) == 3 and t.ancestor_of(13) == 5
    for i in range(12):
        assert t.ancestor_of(20 + i) == 8 + i


def test_children(golden_tree):
    t = golden_tree
    assert len(t.children_of(0)) == 2
    assert len(t.children_of(1)) == 3
    assert len(t.children_of(2)) == 2
    assert len(t.children_of(5)) == 2
    assert len(t.children_of(6)) == 3
    for idx in range(8, 20):
        assert len(t.children_of(idx)) == 1


def test_children_of_leaf_raises(golden_tree):
    with pytest.raises(IndexError):
        golden_tree.children_of(20)


def test_stages(golden_tree):
    t = golden_tree
    assert t.stage_of(0) == 0
    assert t.stage_of(1) == 1 and t.stage_of(2) == 1
    assert all(t.stage_of(i) == 2 for i in range(3, 8))
    assert all(t.stage_of(i) == 3 for i in range(8, 20))
    assert all(t.stage_of(i) == 4 for i in range(20, 32))


def test_stage_of_failures(golden_tree):
    with pytest.raises(ValueError):
        golden_tree.stage_of(-1)
    with pytest.raises(IndexError):
        golden_tree.stage_of(32)


def test_nodes_at_stage(golden_tree):
    t = golden_tree
    assert (t.nodes_at_stage(1) == [1, 2]).all()
    assert (t.nodes_at_stage(2) == np.arange(3, 8)).all()
    assert (t.nodes_at_stage(3) == np.arange(8, 20)).all()
    assert (t.nodes_at_stage(4) == np.arange(20, 32)).all()


def test_probabilities(golden_tree):
    t = golden_tree
    expected = {0: 1, 1: 0.5, 2: 0.5, 3: 0.05, 4: 0.4, 5: 0.05, 6: 0.2,
                7: 0.3, 8: 0.005, 20: 0.005, 29: 0.5 * 0.4 * 0.1}
    for node, prob in expected.items():
        assert t.probability_of_node(node) == pytest.approx(prob, abs=1e-10)


def test_siblings(golden_tree):
    t = golden_tree
    assert len(t.siblings_of_node(0)) == 1
    assert len(t.siblings_of_node(1)) == 2
    assert len(t.siblings_of_node(3)) == 3
    assert len(t.siblings_of_node(7)) == 2
    for i in range(20, 32):
        assert len(t.siblings_of_node(i)) == 1


def test_w_values(golden_tree):
    t = golden_tree
    assert (t.value_at_node(range(1, 3)) == [0, 1]).all()
    assert (t.value_at_node(range(3, 8)) == [0, 1, 2, 0, 1]).all()
    assert (t.value_at_node(range(8, 20))
            == [0, 1, 2, 0, 1, 1, 2, 0, 1, 2, 0, 1]).all()
    assert (t.value_at_node(range(8, 20))
            == t.value_at_node(range(20, 32))).all()


def test_conditional_probabilities_sum_to_one(golden_tree):
    t = golden_tree
    for stage in range(t.num_stages - 1):
        for node in t.nodes_at_stage(stage):
            cond = t.conditional_probabilities_of_children(node)
            assert cond.sum() == pytest.approx(1.0, abs=1e-10)


def test_conditional_probabilities_large_random_tree():
    rng = np.random.default_rng(1)
    n = 4
    p = rng.random((n, n))
    p /= p.sum(axis=1, keepdims=True)
    v = rng.random(n)
    v /= v.sum()
    tree = MarkovChainScenarioTreeFactory(p, v, 20, 5).create()
    for stage in range(tree.num_stages - 1):
        for node in tree.nodes_at_stage(stage):
            cond = tree.conditional_probabilities_of_children(node)
            assert cond.sum() == pytest.approx(1.0, abs=1e-10)


def test_index_plans(golden_tree):
    t = golden_tree
    # padded child table reproduces children_of
    for i in range(t.num_nonleaf_nodes):
        padded = t.children_padded[i][t.children_mask[i]]
        assert (padded == t.children_of(i)).all()
    # child_rank inverts child_first
    for j in range(1, t.num_nodes):
        a = t.ancestor_of(j)
        assert t.child_first[a] + t.child_rank[j] == j
    # stage offsets
    for k in range(t.num_stages):
        nodes = t.nodes_at_stage(k)
        assert t.stage_start[k] == nodes[0]
        assert t.stage_start[k + 1] == nodes[-1] + 1


def test_node_data_roundtrip(golden_tree):
    data = {"anything": np.eye(2)}
    golden_tree.set_data_at_node(5, data)
    assert golden_tree.get_data_at_node(5) == data
    assert golden_tree.get_data_at_node(0) is None


def test_stopping_time_validation():
    rng = np.random.default_rng(2)
    p = rng.random((3, 3))
    p /= p.sum(axis=1, keepdims=True)
    v = rng.random(3)
    v /= v.sum()
    with pytest.raises(ValueError):
        MarkovChainScenarioTreeFactory(p, v, 4, 5).create()


def test_bad_probability_vectors():
    p_good = np.array([[0.5, 0.5], [0.5, 0.5]])
    with pytest.raises(ValueError):
        MarkovChainScenarioTreeFactory(p_good, np.array([0.5, 0.6]), 3)
    with pytest.raises(ValueError):
        MarkovChainScenarioTreeFactory(np.array([[0.5, 0.6], [0.5, 0.5]]),
                                       np.array([0.5, 0.5]), 3)


def test_degenerate_horizons():
    p = np.array([[0.1, 0.8, 0.1], [0.4, 0.6, 0.0], [0.0, 0.3, 0.7]])
    v = np.array([0.5, 0.4, 0.1])
    t1 = MarkovChainScenarioTreeFactory(p, v, 1, 1).create()
    assert t1.num_stages == 2
    t2 = MarkovChainScenarioTreeFactory(p, v, 3, 1).create()
    assert t2.num_stages == 4
    # after the stopping time all nodes have exactly one child
    for i in t2.nodes_at_stage(1):
        assert len(t2.children_of(i)) == 1


def test_large_tree_construction_scales():
    """10^5-node tree builds in O(nodes) time (the reference's repeated
    np.concatenate growth is quadratic — scenario_tree.py:294-313)."""
    import time

    p = np.full((3, 3), 1.0 / 3)
    v = np.full(3, 1.0 / 3)
    tic = time.perf_counter()
    tree = MarkovChainScenarioTreeFactory(p, v, 10, 10).create()
    toc = time.perf_counter()
    assert tree.num_nodes == 1 + sum(3 ** k for k in range(1, 11))  # 88573
    assert toc - tic < 30.0
    # structural invariants at scale
    assert tree.num_nonleaf_nodes == tree.num_nodes - 3 ** 10
    probs = tree.probabilities
    leaves = np.arange(tree.num_nonleaf_nodes, tree.num_nodes)
    np.testing.assert_allclose(probs[leaves].sum(), 1.0, atol=1e-9)
