"""The port's data contracts and configuration copy against the JAX
package: bit packing (int32 here, uint32 there, same bits) and every
config field."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu import config as jconfig
from modular_slam_tpu import types as jtypes
from modular_slam_tpu_torch import config as tconfig
from modular_slam_tpu_torch import types as ttypes


def test_pack_unpack_pm1_match_jax():
    bits = np.random.default_rng(0).integers(0, 2, (9, 256)).astype(np.uint8)
    bits[0] = 1  # every word 0xFFFFFFFF: the sign bit set
    ref = np.asarray(jtypes.pack_bits(jnp.asarray(bits)))
    got = ttypes.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.view(np.int32))
    np.testing.assert_array_equal(ttypes.unpack_bits(got).numpy(), bits)
    np.testing.assert_array_equal(
        ttypes.bits_to_pm1(torch.from_numpy(bits)).numpy(),
        np.asarray(jtypes.bits_to_pm1(jnp.asarray(bits))))
    assert ttypes.LUMA_WEIGHTS == jtypes.LUMA_WEIGHTS


@pytest.mark.parametrize("make", ["SlamConfig", "tiny_test_config",
                                  "tum_camera_config"])
def test_config_copy_equals_jax_config(make):
    ref = getattr(jconfig, make)()
    got = getattr(tconfig, make)()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_config_copy_has_every_class_and_field():
    for name, cls in vars(jconfig).items():
        if dataclasses.is_dataclass(cls) and isinstance(cls, type):
            port_cls = getattr(tconfig, name)
            assert ([f.name for f in dataclasses.fields(port_cls)]
                    == [f.name for f in dataclasses.fields(cls)]), name
            assert dataclasses.asdict(port_cls()) == \
                dataclasses.asdict(cls()), name
