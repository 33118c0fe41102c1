"""Native C++ graph builder vs the pure-Python reference path."""

import glob

import numpy as np
import pytest

from scaling_rgcn_training_tpu.graphs import _native, nt
from scaling_rgcn_training_tpu.graphs.graph import Graph
from scaling_rgcn_training_tpu.graphs import processing as proc

pytestmark = pytest.mark.skipif(
    _native.get_lib() is None,
    reason="native/build/libntgraph.so not built (make -C native)")


@pytest.mark.parametrize("rel", [
    "TEST/TEST_complete.nt",
    "AIFB/attr/sum/AIFB_sum_in.nt",
    "MUTAG/attr/map/MUTAG_map_in.nt",
])
def test_native_parity(ref_graphs_dir, rel):
    path = f"{ref_graphs_dir}/{rel}"
    gp = Graph("py")
    gp.init_graph(nt.read_lines(path))
    gn = Graph("native")
    type_pairs = gn.init_from_native(path)
    assert type_pairs is not None
    assert gp.nodes == gn.nodes
    assert gp.relations == gn.relations
    assert gp.num_edges == gn.num_edges
    np.testing.assert_array_equal(gp.edge_src, gn.edge_src)
    np.testing.assert_array_equal(gp.edge_dst, gn.edge_dst)
    np.testing.assert_array_equal(gp.edge_type, gn.edge_type)


def test_native_type_pairs_match_python_labels(ref_graphs_dir):
    path = f"{ref_graphs_dir}/TEST/TEST_complete.nt"
    triples = nt.read_triples(path)
    g = Graph("native")
    pairs = g.init_from_native(path)
    assert proc.get_classes_from_pairs(pairs) == proc.get_classes(triples)
    classes = proc.get_classes(triples)
    assert dict(proc.nodes2type_from_pairs(pairs, classes)) == \
        dict(proc.nodes2type_mapping(triples, classes))


def test_dataset_native_equals_python(ref_graphs_dir):
    from scaling_rgcn_training_tpu.graphs.dataset import Dataset

    org = f"{ref_graphs_dir}/TEST/TEST_complete.nt"
    s, m = f"{ref_graphs_dir}/TEST/attr/sum", f"{ref_graphs_dir}/TEST/attr/map"
    d_n = Dataset(org, s, m).init_dataset(verbose=False, use_native=True)
    d_p = Dataset(org, s, m).init_dataset(verbose=False, use_native=False)
    assert d_n.num_classes == d_p.num_classes
    np.testing.assert_array_equal(d_n.orgGraph.x_train, d_p.orgGraph.x_train)
    np.testing.assert_array_equal(d_n.orgGraph.y_test, d_p.orgGraph.y_test)
    for a, b in zip(d_n.sumGraphs, d_p.sumGraphs):
        assert a.nodes == b.nodes
        np.testing.assert_array_equal(a.x_train, b.x_train)
        np.testing.assert_array_equal(a.y_train, b.y_train)
