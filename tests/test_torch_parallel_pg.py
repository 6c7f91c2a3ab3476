"""The edge-sharded pose-graph PCG (backend/pose_graph.optimize(mesh=)) vs
the JAX reference (CPU).

On test_torch_backend's seeded random graph (20 nodes, 25 edges; scalar,
diagonal and full weights), carried across with convert.pose_graph_from_jax:
the reference's optimize(mesh=make_mesh(4, "edges")) on the suite's 8-device
virtual CPU mesh (3 padding edges) against the port's optimize on 2 spawned
gloo ranks (1 padding edge) and on one device. pose_graph_trajectory on 2
ranks is held in test_torch_backend.py, beside the reference run it needs.
"""

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu.backend import pose_graph as jpg
from droplet_visual_odometry_tpu.parallel import sharding as jsharding

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch.backend import pose_graph as tpg

from test_torch_backend import WEIGHT_FORMS, _jgraph, _random_graph
from torch_mp_worker import run_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graphs():
    """{form: (reference graph, the port's copy)}."""
    out = {}
    for form in WEIGHT_FORMS:
        jg = _jgraph(_random_graph(form))
        out[form] = (jg, convert.pose_graph_from_jax(jg, device="cpu"))
    return out


@pytest.fixture(scope="module")
def ranks(graphs, tmp_path_factory):
    inputs = {"pcg_graphs": {form: (tg, tpg.PoseGraphConfig()) for form, (_, tg) in graphs.items()}}
    return run_ranks(tmp_path_factory.mktemp("pcg_ranks"), ["pcg"], inputs)


def test_pose_graph_from_jax_carries_the_graph(graphs):
    """Every field equal, float32 poses and int64 edges on the asked device."""
    for jg, tg in graphs.values():
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tg.edge_i.dtype == torch.int64 and tg.poses.dtype == torch.float32


@pytest.mark.parametrize("form", WEIGHT_FORMS)
def test_edge_sharded_optimize_agrees(graphs, ranks, form):
    """2 ranks against the reference's 4-device edge-sharded optimize:
    test_torch_backend's one-device hold (poses 1e-4, initial cost rtol 1e-5,
    final cost rtol 1e-3); against the port's own one-device optimize:
    poses 1e-4 (C.2's index_add_ tolerance; only the order of the edge sums
    changes), both ranks equal bit for bit, and the cost falls."""
    jg, tg = graphs[form]
    ref = jpg.optimize(jg, jpg.PoseGraphConfig(), mesh=jsharding.make_mesh(4, axis_name="edges"))
    single = tpg.optimize(tg, tpg.PoseGraphConfig())
    outs = [r["pcg_" + form] for r in ranks]
    torch.testing.assert_close(outs[0]["poses"], outs[1]["poses"], rtol=0, atol=0)
    out = outs[0]
    print(f"{form}: 2 ranks vs one device {float((out['poses'] - single.poses).abs().max()):.3e}, "
          f"vs the reference {float(np.abs(out['poses'].numpy() - np.asarray(ref.poses)).max()):.3e}")
    assert float(out["final_cost"]) < float(out["initial_cost"])
    np.testing.assert_allclose(float(out["initial_cost"]), float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(out["final_cost"]), float(ref.final_cost), rtol=1e-3)
    np.testing.assert_allclose(out["poses"].numpy(), np.asarray(ref.poses), atol=1e-4)
    np.testing.assert_allclose(out["poses"].numpy(), single.poses.numpy(), atol=1e-4)
