"""The port's pose_graph backend vs the JAX reference (CPU).

Modules: se3_log/adjoint/ad, keyframes, the PCG pose graph on a seeded
random graph, the config builders; then pose_graph_trajectory fed the same
VO outputs on both sides, and run_experiment(backend="pose_graph") end to
end on a small marker-gap loop sequence. Loop closure's retrieval and
verification are held against the reference in test_torch_loop_closure.py.
Tolerances are stated per test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from droplet_visual_odometry_tpu import pipeline as jpipe
from droplet_visual_odometry_tpu.backend import keyframes as jkf
from droplet_visual_odometry_tpu.backend import loop_closure as jlc
from droplet_visual_odometry_tpu.backend import pose_graph as jpg
from droplet_visual_odometry_tpu.backend import refine as jrefine
from droplet_visual_odometry_tpu.core import se3 as jse3
from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig as JRansacConfig
from droplet_visual_odometry_tpu.estimation.vo import VOConfig as JVOConfig
from droplet_visual_odometry_tpu.utils import config as jconfig

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch import pipeline as tpipe
from droplet_visual_odometry_tpu_torch.backend import keyframes as tkf
from droplet_visual_odometry_tpu_torch.backend import pose_graph as tpg
from droplet_visual_odometry_tpu_torch.backend import refine as trefine
from droplet_visual_odometry_tpu_torch.core import se3 as tse3
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.eval import metrics as tmetrics
from droplet_visual_odometry_tpu_torch.eval import tum as ttum

from torch_backend_data import LC_KW, LOOP_CFG, RANSAC_KW, REFINE_KW, jax_verify_draws, mask_marker_midrun
from torch_mp_worker import FixedDraws, run_ranks

torch.set_num_threads(2)


def _twists(rng, n, rot_scale, trans_scale):
    xi = np.concatenate([rng.normal(scale=trans_scale, size=(n, 3)), rng.normal(scale=rot_scale, size=(n, 3))], 1)
    return xi.astype(np.float32)


def _exp(xi):
    return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))


# --------------------------------------------------------------------------
# core/se3
# --------------------------------------------------------------------------


def test_se3_log_agrees():
    """Rotations from 0 through the series branch (< 1 rad) into the exact
    half-angle branch (up to ~2.8 rad): twists to 1e-5."""
    rng = np.random.default_rng(20)
    xi = _twists(rng, 64, 0.8, 0.7)
    xi[0] = 0.0
    xi[1, 3:] = [1e-7, 0.0, 0.0]
    xi[2, 3:] = [0.0, 2.8, 0.0]
    T = _exp(xi)
    ref = np.asarray(jse3.se3_log(jnp.asarray(T)))
    out = tse3.se3_log(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    theta = np.linspace(0.0, 3.0, 31, dtype=np.float32)
    np.testing.assert_allclose(tse3._log_coeff(torch.from_numpy(theta)).numpy(),
                               np.asarray(jse3._log_coeff(jnp.asarray(theta))), atol=1e-5)


def test_adjoint_and_ad_agree():
    """Adj(T) and ad(xi) to 1e-5, and the adjoint identity
    T exp(xi) T^-1 = exp(Adj(T) xi) on the port's side, in f64, to 1e-6."""
    rng = np.random.default_rng(21)
    T = _exp(_twists(rng, 16, 0.5, 1.0))
    xi = _twists(rng, 16, 0.3, 0.3)
    np.testing.assert_allclose(tse3.adjoint(torch.from_numpy(T)).numpy(),
                               np.asarray(jse3.adjoint(jnp.asarray(T))), atol=1e-5)
    np.testing.assert_allclose(tse3.ad(torch.from_numpy(xi)).numpy(), np.asarray(jse3.ad(jnp.asarray(xi))), atol=1e-5)
    Tt, xt = torch.from_numpy(T).double(), torch.from_numpy(xi).double()
    lhs = Tt @ tse3.se3_exp(xt) @ tse3.inverse(Tt)
    rhs = tse3.se3_exp((tse3.adjoint(Tt) @ xt[..., None])[..., 0])
    torch.testing.assert_close(lhs, rhs, rtol=0, atol=1e-6)  # exp's truncated series: ~1e-7


# --------------------------------------------------------------------------
# backend/keyframes
# --------------------------------------------------------------------------


def test_select_keyframes_equal():
    """Host numpy on both sides: the same mask exactly, over every trigger
    (translation, rotation, weak tracking, max gap)."""
    rng = np.random.default_rng(22)
    steps = _twists(rng, 80, 0.03, 0.02)
    steps[40:50] *= 0.01  # a still span: only max_gap re-keys
    abs_poses = [np.eye(4)]
    for s in _exp(steps).astype(np.float64):
        abs_poses.append(s @ abs_poses[-1])
    abs_poses = np.stack(abs_poses)
    n_inliers = rng.integers(30, 300, size=len(abs_poses) - 1)
    for kw in (dict(), dict(min_translation=0.02, min_rotation_deg=2.0, min_inliers=100, max_gap=4)):
        ref = jkf.select_keyframes(abs_poses, n_inliers, jkf.KeyframeConfig(**kw))
        out = tkf.select_keyframes(abs_poses, n_inliers, tkf.KeyframeConfig(**kw))
        np.testing.assert_array_equal(out, ref)
        assert 2 < out.sum() < len(out)


# --------------------------------------------------------------------------
# backend/pose_graph on a seeded random graph
# --------------------------------------------------------------------------

N_NODES = 20


def _random_graph(weight_form, seed=23):
    """A drifting chain of 20 nodes plus 6 loop edges, measurements with
    noise; scalar, diagonal or full SPD weights. numpy arrays."""
    rng = np.random.default_rng(seed)
    true = [np.eye(4)]
    for s in _exp(_twists(rng, N_NODES - 1, 0.05, 0.1)).astype(np.float64):
        true.append(true[-1] @ s)
    true = np.stack(true)
    ei = list(range(N_NODES - 1)) + [0, 2, 5, 3, 8, 1]
    ej = list(range(1, N_NODES)) + [15, 18, 19, 12, 17, 10]
    noise = _exp(_twists(rng, len(ei), 0.01, 0.02)).astype(np.float64)
    meas = np.stack([np.linalg.inv(true[i]) @ true[j] @ n for i, j, n in zip(ei, ej, noise)])
    drift = _exp(_twists(rng, N_NODES, 0.02, 0.05)).astype(np.float64)
    drift[0] = np.eye(4)
    poses = np.einsum("nab,nbc->nac", true, drift)
    E = len(ei)
    if weight_form == "scalar":
        w = rng.uniform(0.5, 2.0, size=E)
    elif weight_form == "diag":
        w = rng.uniform(0.2, 3.0, size=(E, 6))
    else:
        A = rng.normal(size=(E, 6, 6))
        w = np.einsum("eab,ecb->eac", A, A) / 6 + 0.1 * np.eye(6)
    return dict(poses=poses.astype(np.float32), ei=np.asarray(ei), ej=np.asarray(ej),
                meas=meas.astype(np.float32), w=w.astype(np.float32))


def _jgraph(g):
    return jpg.PoseGraph(jnp.asarray(g["poses"]), jnp.asarray(g["ei"], jnp.int32), jnp.asarray(g["ej"], jnp.int32),
                         jnp.asarray(g["meas"]), jnp.asarray(g["w"]))


def _tgraph(g):
    return tpg.PoseGraph(torch.from_numpy(g["poses"]), torch.from_numpy(g["ei"]), torch.from_numpy(g["ej"]),
                         torch.from_numpy(g["meas"]), torch.from_numpy(g["w"]))


WEIGHT_FORMS = ["scalar", "diag", "full"]


@pytest.mark.parametrize("form", WEIGHT_FORMS)
def test_graph_terms_agree(form):
    """weight_matrices exactly; residuals, cost, normal blocks, the
    scatter-added gradient and block diagonal and one Hessian-vector product
    to 1e-5 relative (f32 products in another order)."""
    g = _random_graph(form)
    jg, tg = _jgraph(g), _tgraph(g)
    np.testing.assert_array_equal(tpg.weight_matrices(tg.edge_weight).numpy(), np.asarray(jpg.weight_matrices(jg.edge_weight)))
    np.testing.assert_allclose(tpg._edge_residuals(tg.poses, tg).numpy(), np.asarray(jpg._edge_residuals(jg.poses, jg)),
                               atol=1e-5)
    np.testing.assert_allclose(float(tpg.cost(tg)), float(jpg.cost(jg)), rtol=1e-5)
    B, gv = tpg._edge_blocks(tg.poses, tg)
    Bj, gj = jpg._edge_blocks(jg.poses, jg)
    scale = float(np.abs(np.asarray(Bj)).max())
    np.testing.assert_allclose(B.numpy(), np.asarray(Bj), atol=1e-5 * scale)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gj), atol=1e-5 * scale)
    b, D = tpg._assemble_rhs_diag(N_NODES, tg, B, gv)
    bj, Dj = jpg._assemble_rhs_diag(N_NODES, jg, Bj, gj)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), atol=1e-5 * scale)
    np.testing.assert_allclose(D.numpy(), np.asarray(Dj), atol=1e-5 * scale)
    x = np.random.default_rng(24).normal(size=(N_NODES, 6)).astype(np.float32)
    np.testing.assert_allclose(tpg._hx_local(B, tg.edge_i, tg.edge_j, torch.from_numpy(x)).numpy(),
                               np.asarray(jpg._hx_local(Bj, jg.edge_i, jg.edge_j, jnp.asarray(x))), atol=1e-4 * scale)
    np.testing.assert_array_equal(tpg._gauge_mask(N_NODES, B).numpy(), np.asarray(jpg._gauge_mask(N_NODES, jnp.float32)))


def _pcg_while(matvec, b, Minv, iters, tol):
    """The reference's while loop (pose_graph.py:143-172), op for op, with a
    host test of the stop condition."""
    apply_minv = lambda r: torch.einsum("mab,mb->ma", Minv, r)
    x, r = torch.zeros_like(b), b
    z = apply_minv(r)
    p = z
    stop = tol * torch.clamp(torch.sum(b * b), min=1e-30)
    k = 0
    while k < iters and bool(torch.sum(r * r) > stop):
        Hp = matvec(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z_new = apply_minv(r)
        beta = torch.sum(r * z_new) / torch.clamp(rz, min=1e-30)
        p = z_new + beta * p
        z = z_new
        k += 1
    return x, k


@pytest.mark.parametrize("cg_iters", [3, 100])
def test_pcg_frozen_steps_equal_while_loop(cg_iters):
    """The device-side stop (all steps issued, step length 0 once the test
    fails) gives the while loop's x bit for bit, whether the cap (3 steps)
    or the tolerance ends it; the port's PCG solve agrees with the
    reference's to 1e-4 relative."""
    g = _random_graph("full")
    tg, jg = _tgraph(g), _jgraph(g)
    B, gv = tpg._edge_blocks(tg.poses, tg)
    b, D = tpg._assemble_rhs_diag(N_NODES, tg, B, gv)
    gm = tpg._gauge_mask(N_NODES, B)
    eye6 = torch.eye(6)
    Minv = torch.linalg.inv_ex(torch.cat([eye6[None], (D + 1e-6 * eye6)[1:]])).inverse

    def matvec(x):
        x = x * gm
        return tpg._hx_local(B, tg.edge_i, tg.edge_j, x) * gm + 1e-6 * x

    x = tpg._pcg(matvec, b * gm, Minv, cg_iters, 1e-8)
    x_ref, steps = _pcg_while(matvec, b * gm, Minv, cg_iters, 1e-8)
    assert steps == 3 if cg_iters == 3 else 3 < steps < cg_iters
    assert torch.equal(x, x_ref)
    x_solve = tpg._solve_pcg(N_NODES, tg, B, gv, tpg.PoseGraphConfig(cg_iters=cg_iters))
    assert torch.equal(x_solve, x)
    Bj, gj = jpg._edge_blocks(jg.poses, jg)
    xj = jpg._solve_pcg(N_NODES, jg, Bj, gj, jpg.PoseGraphConfig(cg_iters=cg_iters), None)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-4 * float(x.abs().max()))


@pytest.mark.parametrize("solver,form", [("pcg", "scalar"), ("pcg", "diag"), ("pcg", "full"), ("dense", "full")])
def test_optimize_agrees(solver, form):
    """Ten GN steps on the drifted graph: the cost falls by > 10x on both
    sides, final costs to 1e-3 relative and poses to 1e-4 (f32 CG in another
    summation order)."""
    g = _random_graph(form)
    cfg_kw = dict(iters=10, solver=solver)
    ref = jpg.optimize_jit(_jgraph(g), jpg.PoseGraphConfig(**cfg_kw), mesh=None)
    out = tpg.optimize(_tgraph(g), tpg.PoseGraphConfig(**cfg_kw))
    assert float(out.final_cost) < 0.1 * float(out.initial_cost)
    np.testing.assert_allclose(float(out.initial_cost), float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(out.final_cost), float(ref.final_cost), rtol=1e-3)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=1e-4)


def test_pad_graph_keeps_real_nodes_and_dense_matches_pcg():
    """Padding to (32, 64) leaves the real nodes' optimum unchanged (to 1e-6:
    the zero filler changes only the length of the sums), the padded graph
    equals the reference's padding exactly, and the dense solve agrees with
    the reference's and, to 1e-4 relative, with a PCG solve of the same GN
    system run to a relative residual of 1e-7."""
    g = _random_graph("diag")
    tg = _tgraph(g)
    padded = tpg.pad_graph(tg, 32, 64)
    jpadded = jpg.pad_graph(_jgraph(g), 32, 64)
    for a, b in zip(padded, jpadded):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfg = tpg.PoseGraphConfig(iters=5)
    plain = tpg.optimize(tg, cfg)
    pad = tpg.optimize(padded, cfg)
    np.testing.assert_allclose(pad.poses[:N_NODES].numpy(), plain.poses.numpy(), atol=1e-6)
    torch.testing.assert_close(pad.poses[N_NODES:], torch.eye(4).expand(32 - N_NODES, 4, 4), rtol=0, atol=0)
    np.testing.assert_allclose(float(pad.final_cost), float(plain.final_cost), rtol=1e-6)
    B, gv = tpg._edge_blocks(tg.poses, tg)
    dense = tpg._solve_dense(N_NODES, tg, B, gv, 1e-6)
    pcg = tpg._solve_pcg(N_NODES, tg, B, gv, tpg.PoseGraphConfig(cg_iters=500, cg_tol=1e-14))
    np.testing.assert_allclose(dense.numpy(), pcg.numpy(), atol=1e-4 * float(dense.abs().max()))
    Bj, gj = jpg._edge_blocks(_jgraph(g).poses, _jgraph(g))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jpg._solve_dense(N_NODES, _jgraph(g), Bj, gj, 1e-6)),
                               atol=1e-4 * float(dense.abs().max()))
    with pytest.raises(ValueError):
        tpg.pad_graph(tg, 16, 64)


def test_graph_builders_agree():
    """sequential_edges, add_edges (scalar onto diag and full promotion),
    scale_free_weight and next_bucket against the reference: exactly, or to
    1e-6 where an f32 product is summed."""
    g = _random_graph("scalar")
    X = g["poses"]
    ts, js = tpg.sequential_edges(torch.from_numpy(X), 0.5), jpg.sequential_edges(jnp.asarray(X), 0.5)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    meas = g["meas"][-6:]
    sfw = tpg.scale_free_weight(torch.from_numpy(meas), 2.0, 0.5)
    np.testing.assert_allclose(sfw.numpy(), np.asarray(jpg.scale_free_weight(jnp.asarray(meas), 2.0, 0.5)), atol=1e-6)
    for w_new in (np.full((6, 6), 1.5, np.float32), sfw.numpy()):
        out = tpg.add_edges(ts, g["ei"][-6:], g["ej"][-6:], torch.from_numpy(meas), torch.from_numpy(w_new))
        ref = jpg.add_edges(js, jnp.asarray(g["ei"][-6:]), jnp.asarray(g["ej"][-6:]), jnp.asarray(meas), jnp.asarray(w_new))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for n in (0, 5, 16, 17, 100, 1024):
        assert tpg.next_bucket(n) == jpg.next_bucket(n)


# --------------------------------------------------------------------------
# The slice on a small marker-gap loop sequence
# --------------------------------------------------------------------------


def _jrefine_cfg():
    return jrefine.PoseGraphRefineConfig(lc=jlc.LoopClosureConfig(**LC_KW), **REFINE_KW)


def _trefine_cfg():
    return convert.pose_graph_refine_config_from_dict(dataclasses.asdict(_jrefine_cfg()))


@pytest.fixture(scope="module")
def loop_seqs():
    j = mask_marker_midrun(jsynth.render_sequence(jsynth.SyntheticConfig(**LOOP_CFG)))
    t = mask_marker_midrun(tsynth.render_sequence(tsynth.SyntheticConfig(**LOOP_CFG)))
    np.testing.assert_array_equal(t.frames, j.frames)
    return j, t


@pytest.fixture(scope="module")
def jax_pg_run(loop_seqs):
    """The reference's run_experiment(backend="pose_graph") (its PCG sharded
    over the suite's 8 CPU devices, which changes only summation order)."""
    vo = JVOConfig(scale_mode="hold", ransac=JRansacConfig(**RANSAC_KW))
    return jpipe.run_experiment(loop_seqs[0], vo, backend="pose_graph", refine_cfg=_jrefine_cfg())


@pytest.fixture(scope="module")
def vo_outputs(loop_seqs, jax_pg_run):
    """The reference run's VO outputs (before its backend), fed to both
    backends: absolute poses (frame 0 carries the marker, so no re-anchor),
    inlier counts, live-scale bits, marker corners and intrinsics."""
    seq = loop_seqs[0]
    traj = jax_pg_run.trajectory
    return dict(
        abs_poses=np.asarray(traj.abs_poses, np.float64), n_inliers=np.asarray(traj.n_inliers),
        scale_ok=np.asarray(traj.scale_ok), corners=np.asarray(seq.marker_corners, np.float32),
        present=np.asarray(seq.marker_present), K=np.asarray(seq.camera.K, np.float32), L=seq.real_marker_length,
    )


def test_pose_graph_trajectory_agrees(loop_seqs, vo_outputs):
    """The same VO outputs into both backends (the reference's PCG on one
    device, mesh=None; its verification jitted, the port replaying its
    draws): keyframes, bridge pairs and loop pairs equal, the graph cost
    falls, refined poses to 5 mm / 5e-3 (inliers may differ by 2% under
    jit, ROADMAP C)."""
    o = vo_outputs
    common = (o["abs_poses"], o["n_inliers"], o["corners"], o["present"])
    ref, ref_info = jrefine.pose_graph_trajectory(
        jnp.asarray(loop_seqs[0].frames, jnp.float32), *common, jnp.asarray(o["K"]), o["L"],
        JVOConfig(scale_mode="hold", ransac=JRansacConfig(**RANSAC_KW)), _jrefine_cfg(),
        pair_scale_ok=o["scale_ok"], mesh=None,
    )
    tvo = convert.vo_config_from_dict(dataclasses.asdict(JVOConfig(scale_mode="hold", ransac=JRansacConfig(**RANSAC_KW))))
    out, info = trefine.pose_graph_trajectory(
        torch.from_numpy(loop_seqs[1].frames).float(), *common, o["K"], o["L"], tvo, _trefine_cfg(),
        pair_scale_ok=o["scale_ok"], draws=jax_verify_draws,
    )
    print(f"port {info}\nreference {ref_info}")
    for key in ("n_keyframes", "n_bridge_pairs", "n_loop_edges", "loop_pairs"):
        assert info[key] == ref_info[key], key
    assert info["n_bridge_pairs"] == 1 and info["n_loop_edges"] >= 2
    assert info["pg_final_cost"] < info["pg_initial_cost"] and info["pg_mesh_devices"] == 1
    np.testing.assert_allclose(info["pg_initial_cost"], ref_info["pg_initial_cost"], rtol=0.05)
    np.testing.assert_allclose(out, ref, atol=5e-3)


def test_pose_graph_trajectory_on_two_ranks(loop_seqs, vo_outputs, jax_pg_run, tmp_path):
    """The same VO outputs into pose_graph_trajectory on 2 spawned gloo ranks
    (mesh="auto": the PCG's product sharded over the default group) and on
    one device, the reference's verification draws replayed on both:
    pg_mesh_devices 2 (the reference's run: its 8 CPU devices), loop pairs
    equal to the reference's; refined poses within 5e-3 of the reference's
    edge-sharded run (test_pose_graph_trajectory_agrees's hold) and 1e-4 of
    the port's one-device run (only the order of the edge sums changes)."""
    o = vo_outputs
    tvo = convert.vo_config_from_dict(dataclasses.asdict(JVOConfig(scale_mode="hold", ransac=JRansacConfig(**RANSAC_KW))))
    args = (torch.from_numpy(loop_seqs[1].frames).float(), o["abs_poses"], o["n_inliers"], o["corners"], o["present"],
            o["K"], o["L"], tvo, _trefine_cfg())
    recorded = []
    draws = lambda n: recorded.append(jax_verify_draws(n)) or recorded[-1]
    one, one_info = trefine.pose_graph_trajectory(*args, pair_scale_ok=o["scale_ok"], draws=draws)
    assert one_info["pg_mesh_devices"] == 1
    ranks = run_ranks(tmp_path, ["pg_trajectory"], {
        "pgt_args": args, "pgt_kwargs": dict(pair_scale_ok=o["scale_ok"], draws=FixedDraws(*recorded[-1]))})
    ref_info = jax_pg_run.backend_info
    assert ref_info["pg_mesh_devices"] == 8
    for r in ranks:
        info, out = r["pgt_info"], r["pgt_poses"]
        print(f"2 ranks vs one device {np.abs(out - one).max():.3e}, vs the reference {np.abs(out - jax_pg_run.vo_abs).max():.3e}")
        assert info["pg_mesh_devices"] == 2
        assert info["loop_pairs"] == one_info["loop_pairs"] == ref_info["loop_pairs"]
        assert info["pg_final_cost"] < info["pg_initial_cost"]
        np.testing.assert_allclose(out, one, atol=1e-4)
        np.testing.assert_allclose(out, jax_pg_run.vo_abs, atol=5e-3)


def test_run_experiment_pose_graph_agrees(loop_seqs, jax_pg_run, tmp_path):
    """The slice end to end on the CPU with its default draws, the
    reference's for seed 0: the six TUM files, the graph cost falls, the
    drift of the raw VO chain falls by more than a quarter, and the ATE is
    held to the reference's within 1 cm, the replayed-draw tolerance of
    ROADMAP C.2 (measured 2.8 mm; the reference's own seed-to-seed spread is
    0.018 m: ATE RMSE 0.0307 / 0.0228 / 0.0124 / 0.0252 m over RANSAC seeds
    0-3; raw chains 0.070-0.095 m)."""
    tvo = convert.vo_config_from_dict(dataclasses.asdict(JVOConfig(scale_mode="hold", ransac=JRansacConfig(**RANSAC_KW))))
    res = tpipe.run_experiment(loop_seqs[1], tvo, str(tmp_path), 0, backend="pose_graph", refine_cfg=_trefine_cfg(),
                               device="cpu")
    info = res.backend_info
    present = loop_seqs[1].marker_present
    gt_cam = np.linalg.inv(res.gt_abs[present])
    chain = tmetrics.ate(gt_cam, np.linalg.inv(np.asarray(res.trajectory.abs_poses, np.float64)[present])).rmse
    print(f"ATE port {res.ate.rmse} (raw chain {chain}) reference {jax_pg_run.ate.rmse}; port {info}")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(ttum.STREAM_NAMES)
    assert info["pg_final_cost"] < info["pg_initial_cost"]
    assert info["n_bridge_pairs"] == jax_pg_run.backend_info["n_bridge_pairs"] and info["n_loop_edges"] >= 1
    assert np.isfinite(res.vo_abs).all()
    assert res.ate.rmse < 0.75 * chain
    assert abs(res.ate.rmse - jax_pg_run.ate.rmse) < 1e-2


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "builder,ref",
    [
        ("keyframe_config_from_dict", jkf.KeyframeConfig(min_translation=0.1, max_gap=6)),
        ("loop_closure_config_from_dict", jlc.LoopClosureConfig(**LC_KW)),
        ("pose_graph_config_from_dict", jpg.PoseGraphConfig(iters=15, solver="dense")),
        ("pose_graph_refine_config_from_dict", jrefine.PoseGraphRefineConfig(lc=jlc.LoopClosureConfig(shortlist=0))),
        ("experiment_config_from_dict", jconfig.ExperimentConfig(seed=3)),
    ],
)
def test_config_converters_equal(builder, ref):
    """Each builder gives the reference's config field by field, and the
    port's defaults equal the reference's (the shipped default is
    backend='pose_graph' with scale_mode='hold')."""
    out = getattr(convert, builder)(dataclasses.asdict(ref))
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert dataclasses.asdict(type(out)()) == dataclasses.asdict(type(ref)())
