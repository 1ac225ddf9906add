"""robosat_tpu_torch's process group, synchronized batch norm, halo exchange and spatial step.

The port's side runs as gloo ranks, one process each, launched as a user
launches the port on N devices (tests/torch_mesh_workers.py: RS_* set, one
CPU thread each); the JAX side on the suite's 2-device CPU mesh.

- RS_COORDINATOR, RS_NUM_PROCESSES and RS_PROCESS_ID map onto the group
  (rank, world size, gloo for the CPU, the CPU device, each rank's rows);
  without RS_COORDINATOR there is no group and `create_mesh` returns None;
  `cuda = true` without a GPU raises.
- `layers.bn_apply` under `sync_batch_norm` at widths 1, 2 and 4 against
  one process's `bn_apply` (F.batch_norm) on the whole batch: outputs
  within 2e-6 of their largest, running statistics within 1e-6 and input
  gradients within 2e-6 of their largest (float32 sums in another order;
  width 1 is a group of one, the synchronized arithmetic against
  F.batch_norm's).
- Every spatial site of the U-Net's folded forward (3x3 at stride 1 with
  symmetric and SAME pads, 3x3 at stride 2, the 7x7 stride-2 stem, the
  1x1 stride-2 projection, the 3x3/2 and 2x2/2 max pools, the transposed
  conv of the decoder blocks, the s2d dec4 and dec5 kernels) split by
  height over 2 and 4 ranks equals the whole raster's in float64 (the
  same products and sums).
- `make_spatial_predict_step` on 2 ranks at test_parallel.py's shape (1,
  256, 128, 3), overlap 32, float32, against the JAX package's spatial
  step on its 2-device mesh and against the port's one-process
  `make_predict_step(fused_head=True, fold_bn=True, s2d=True)`: uint8
  within one bin on at most 0.1% of the pixels, the flips counted and
  printed (measured: 0). A height that is not a multiple of 64 x ranks
  raises.
"""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from robosat_tpu.models import unet as junet
from robosat_tpu.parallel.mesh import create_mesh as jax_create_mesh
from robosat_tpu.parallel.mesh import replicate as jax_replicate
from robosat_tpu.parallel.steps import make_spatial_predict_step as jax_make_spatial_predict_step
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models import layers, unet
from robosat_tpu_torch.parallel import mesh as pmesh
from robosat_tpu_torch.parallel.steps import make_predict_step, make_spatial_predict_step
from test_torch_port_predict import MAX_FLIP_SHARE, _bin_distance


def test_rs_environment_maps_onto_the_process_group():
    results = workers.launch(workers.rs_environment, 2)
    assert [r[:4] for r in results] == [(0, 2, "gloo", "cpu"), (1, 2, "gloo", "cpu")]
    assert [r[4] for r in results] == [slice(0, 4), slice(4, 8)]


def test_no_coordinator_no_group(monkeypatch):
    monkeypatch.delenv("RS_COORDINATOR", raising=False)
    assert pmesh.maybe_init_distributed() is False
    assert pmesh.create_mesh(torch.device("cpu")) is None
    assert pmesh.shard_batch(None, np.arange(6)).tolist() == list(range(6))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.create_mesh(torch.device("cuda"))


def test_mesh_rows_and_halo_edges():
    """A mesh's rows, `shard_batch`, and a halo deeper than a
    rank's rows (no collective is needed for those checks on one rank's
    view of a 4-rank mesh)."""
    mesh = pmesh.Mesh(1, 4, torch.device("cpu"))
    assert mesh.rows(8) == slice(2, 4)
    assert pmesh.shard_batch(mesh, np.arange(8)).tolist() == [2, 3]
    with pytest.raises(ValueError, match="do not split"):
        mesh.rows(6)
    with pytest.raises(ValueError, match="more than the 2 rows"):
        mesh.halo(torch.zeros(1, 2, 3, 1), 3, 0, 0.0)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_sync_bn_matches_one_process(width):
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((8, 6, 5, 16)) * 3 + 1).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": rng.standard_normal(16).astype(np.float32)}
    state = {"mean": rng.standard_normal(16).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, ref_state = layers.bn_apply({k: torch.from_numpy(v) for k, v in params.items()},
                                   {k: torch.from_numpy(v) for k, v in state.items()}, xt, True)
    (y * torch.from_numpy(dy)).sum().backward()
    ranks = workers.launch(workers.sync_bn, width, params, state, x, dy)
    got_y = np.concatenate([r[0] for r in ranks])
    got_dx = np.concatenate([r[2] for r in ranks])
    ref_y, ref_dx = y.detach().numpy(), xt.grad.numpy()
    print("width {}: y {:.3g}, dx {:.3g} of their largest".format(
        width, np.abs(got_y - ref_y).max() / np.abs(ref_y).max(), np.abs(got_dx - ref_dx).max() / np.abs(ref_dx).max()))
    np.testing.assert_allclose(got_y, ref_y, rtol=0, atol=2e-6 * np.abs(ref_y).max())
    np.testing.assert_allclose(got_dx, ref_dx, rtol=0, atol=2e-6 * np.abs(ref_dx).max())
    for r in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r[1][k], ref_state[k].numpy(), rtol=0, atol=1e-6)


def test_halo_sites_match_the_whole_raster():
    rng = np.random.default_rng(0)
    c = 8
    x = rng.standard_normal((2, 16, 12, 4 * c))
    w = {"w3": rng.standard_normal((3, 3, 4 * c, c)), "w7": rng.standard_normal((7, 7, 4 * c, c)),
         "w1": rng.standard_normal((1, 1, 4 * c, c)), "w3q": rng.standard_normal((3, 3, c, c))}
    whole = {k: v.numpy() for k, v in workers.halo_site_outputs(torch.from_numpy(x), w).items()}
    for size in (2, 4):
        ranks = workers.launch(workers.halo_sites, size, x, w)
        for name, ref in whole.items():
            got = np.concatenate([r[name] for r in ranks], axis=1)
            assert got.shape == ref.shape, (size, name)
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12, err_msg="{} ranks, {}".format(size, name))


def _assert_bins(got, ref):
    d = _bin_distance(got, ref)
    flips = int((d != 0).sum())
    print("uint8 bins differing: {} of {} (max distance {})".format(flips, d.size, d.max(initial=0)))
    assert d.max(initial=0) <= 1 and flips <= MAX_FLIP_SHARE * d.size


def test_spatial_predict_step_matches_jax():
    params, state = jax.tree_util.tree_map(np.asarray, junet.init(0, num_classes=2))
    raw = np.random.default_rng(3).integers(0, 255, (1, 256, 128, 3), dtype=np.uint8)
    mesh = jax_create_mesh()
    assert len(mesh.devices) == 2
    ref = np.asarray(jax_make_spatial_predict_step(junet, mesh, overlap=32)(
        jax_replicate(mesh, params), jax_replicate(mesh, state), jax.device_put(raw)))
    ranks = workers.launch(workers.spatial_predict, 2, params, state, raw, 32)
    tp, ts = from_jax(params, state)
    single = make_predict_step(unet, overlap=32, fused_head=True, fold_bn=True, s2d=True)(tp, ts, raw).numpy()
    assert ref.shape == single.shape == (1, 192, 64)
    for out, launches in ranks:
        assert out.shape == ref.shape and out.dtype == np.uint8
        assert launches == 0  # the CPU runs K1's plain version
        _assert_bins(out, ref)
        _assert_bins(out, single)


def test_spatial_predict_step_checks_the_height():
    params, state = unet.init(0)
    step = make_spatial_predict_step(unet, pmesh.Mesh(0, 2, torch.device("cpu")), overlap=0)
    with pytest.raises(ValueError, match="multiple of 64 x 2"):
        step(params, state, np.zeros((1, 192, 64, 3), np.uint8))
