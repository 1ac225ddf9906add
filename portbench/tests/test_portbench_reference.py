"""The reference against the system's plain path at a tiny size, on the CPU.

The int8 predict of the reference (portbench/reference/<family>.py) must
give the system's bins exactly: on CPU tensors the system's step runs its
kernels' plain versions, of which the reference's int8 arithmetic is a
frozen copy. The float32 training step of the reference must start where
the system's float32 step starts: the first loss and the first gradients.
"""

import numpy as np
import pytest
import torch

from portbench.drivers import train as drive_train
from portbench.harness import gen, weights
from portbench.reference import deeplabv3plus, int8, train, unet
from portbench.reference.layers import normalize_s2d4, space_to_depth4

CPU = torch.device("cpu")


@pytest.mark.parametrize("family,name", [(unet, "unet"), (deeplabv3plus, "deeplabv3plus")])
def test_int8_predict_matches_the_system_bit_for_bit(family, name):
    from robosat_tpu_torch.models.registry import get_model
    from robosat_tpu_torch.parallel.steps import make_int8_predict_step

    torch.manual_seed(0)
    params, state = (weights.make(t, 11, CPU) for t in family.spec())
    fine = gen.aerial_tiles(11, "pool0", 2, 128, CPU)
    weights.init_statistics(family, params, state, fine)
    raw = space_to_depth4(fine)
    step, qtree = make_int8_predict_step(get_model(name), params, state, raw, overlap=32, host_s2d=True)
    got = step(qtree, raw)

    quant = int8.Quant(127)
    folded = family.fold(params, state)
    scales = quant.scales(family.calibrate(folded, normalize_s2d4(raw)))
    want = family.predict_int8(quant, family.quantize(quant, folded), scales,
                               normalize_s2d4(raw).to(torch.bfloat16), 32)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert len(np.unique(want.numpy())) > 100  # the bins spread over the range


@pytest.mark.parametrize("family,name", [(unet, "unet"), (deeplabv3plus, "deeplabv3plus")])
def test_calibration_matches_the_system(family, name):
    from robosat_tpu_torch.models import deeplab as sys_deeplab
    from robosat_tpu_torch.models import int8 as sys_int8
    from robosat_tpu_torch.models.registry import get_model
    from robosat_tpu_torch.parallel.steps import _normalize_s2d4

    params, state = (weights.make(t, 12, CPU) for t in family.spec())
    raw = space_to_depth4(gen.aerial_tiles(12, "pool0", 2, 128, CPU))
    folded = get_model(name).fold(params, state)
    calibrate = sys_deeplab.calibration_amaxes_int8 if name == "deeplabv3plus" else sys_int8.calibration_amaxes
    want = calibrate(folded, _normalize_s2d4(raw), blocked=True).numpy()
    got = family.calibrate(family.fold(params, state), normalize_s2d4(raw))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("family,name", [(unet, "unet"), (deeplabv3plus, "deeplabv3plus")])
def test_float32_training_starts_where_the_system_starts(family, name):
    from robosat_tpu_torch.models.registry import get_model
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.optim import adam
    from robosat_tpu_torch.parallel.steps import make_train_step

    torch.set_num_threads(2)
    images, masks = gen.learnable_batches(13, "train", 1, 2, 64, CPU)[0]
    params, state = (weights.make(t, 13, CPU) for t in family.spec())
    optimizer = adam(params, 1e-4)
    step = make_train_step(get_model(name), get_loss("Lovasz"), optimizer, compute_dtype=torch.float32)
    _, loss, _ = step(params, state, images, masks, torch.Generator().manual_seed(5))
    got = {path: float(optimizer.moments(p)[0].double().norm()) / (1 - drive_train.B1)
           for path, p in train.flatten(params)}

    ref_params, ref_state = (weights.make(t, 13, CPU) for t in family.spec())
    with torch.no_grad():
        ref_images, ref_masks = train.augment(torch.Generator().manual_seed(5), images, masks)
        ref_loss = train.lovasz(family.forward(train.Float32(), ref_params, ref_state, train.normalize(ref_images)),
                                ref_masks)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4)
    grads, _ = train.run(family, ref_params, ref_state, [(images, masks)], torch.Generator().manual_seed(5), 1e-4,
                         train.Float32())
    norms = {k: float(g.double().norm()) for k, g in grads.items()}
    median = float(np.median(list(norms.values())))
    assert max(abs(got[k] - norms[k]) / max(norms[k], median) for k in norms) < 0.02
