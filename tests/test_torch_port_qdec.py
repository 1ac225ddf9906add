"""robosat_tpu_torch K5 and K8: the parity up-convs' plain versions vs the JAX package.

The port's plain version (four 2x2-tap int8 parity convs, interleaved) must
equal both the JAX Pallas kernel qdec.parity_up_conv (interpret mode) and
the XLA lhs-dilated int8 conv the JAX walk runs at these sites, bit for bit.
The parity-separated form (K8) must equal qdec.parity_up_conv_separated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import qdec as jqdec
from robosat_tpu_torch.models import qdec
from robosat_tpu_torch.models.layers import space_to_depth2


def _tnode(node):
    return {k: torch.from_numpy(np.array(v)) for k, v in node.items()}


@pytest.mark.parametrize("cin,cout,h,bias", [(64, 32, 8, False), (96, 48, 6, True), (32, 128, 5, False)])
def test_parity_up_conv_plain_bit_equal(cin, cout, h, bias):
    rng = np.random.default_rng(cin + cout)
    node = jq8._qkernel(jq8._fused_k4(jnp.asarray(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32))))
    if bias:
        node["b"] = jnp.asarray(rng.normal(0, 0.05, (cout,)).astype(np.float32))
    x = jnp.asarray(rng.normal(0, 1.0, (2, h, h, cin)), jnp.bfloat16)
    s = 0.017
    kernel = jqdec.parity_up_conv(x, node, s, strip_rows=1, interpret=True)
    walk = jax.nn.relu(jq8._int8_conv(node, x, s, padding=((2, 2), (2, 2)), lhs_dilation=(2, 2)))
    got = qdec.parity_up_conv(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16), _tnode(node), s)
    assert tuple(got.shape) == (2, 2 * h, 2 * h, cout)
    got = got.float().numpy()
    assert int((np.asarray(kernel, np.float32) != got).sum()) == 0
    assert int((np.asarray(walk, np.float32) != got).sum()) == 0


@pytest.mark.parametrize("cin,cout,h,bias", [(64, 32, 8, False), (128, 48, 12, True), (96, 16, 16, True)])
def test_parity_up_conv_separated_plain_bit_equal(cin, cout, h, bias):
    """K8's plain version equals the JAX Pallas kernel (interpret mode) and
    space_to_depth2 of the port's interleaved up-conv, bit for bit."""
    rng = np.random.default_rng(100 + cin + cout)
    node = jq8._qkernel(jq8._fused_k4(jnp.asarray(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32))))
    if bias:
        node["b"] = jnp.asarray(rng.normal(0, 0.05, (cout,)).astype(np.float32))
    x = jnp.asarray(rng.normal(0, 1.0, (2, h, h, cin)), jnp.bfloat16)
    s = 0.019
    kernel = np.asarray(jqdec.parity_up_conv_separated(x, node, s, strip_rows=4, interpret=True), np.float32)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = qdec.parity_up_conv_separated(tx, _tnode(node), s)
    assert tuple(got.shape) == kernel.shape == (2, h, h, 4 * cout)
    assert int((kernel != got.float().numpy()).sum()) == 0
    assert torch.equal(got, space_to_depth2(qdec.parity_up_conv(tx, _tnode(node), s)))


def test_parity_tap_weights_match_jax():
    wq = np.random.default_rng(2).integers(-127, 128, (4, 4, 8, 16), dtype=np.int8)
    assert np.array_equal(np.asarray(jqdec.parity_tap_weights(jnp.asarray(wq))),
                          qdec.parity_tap_weights(torch.from_numpy(wq)).numpy())
