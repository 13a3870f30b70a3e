"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: explicit JAX mode toggles, and JAX stage parameters in the port's
layout."""

import contextlib

import numpy as np
import torch

from ssunet_gan_tpu.ops import stage_kernel as jax_stage_kernel
from ssunet_gan_tpu.ops import stage_kernel_int8 as jax_stage_kernel_int8
from ssunet_gan_tpu.ops import stage_kernel_train as jax_stage_kernel_train
from ssunet_gan_tpu.ops import wminor as jax_wminor


@contextlib.contextmanager
def jax_toggles(fused_stage: bool, fused_train: bool = False):
    """Set every global mode of the JAX package that the port's tests
    reach, and restore the previous values after (another test in the same
    worker may leave, e.g., the upsample-backward decomposition on). The
    train-stage backward is always the v2 one, the port's."""
    saved = (
        jax_stage_kernel._FUSED_STAGE,
        jax_wminor._LAZY_UPSAMPLE,
        jax_wminor._LAZY_POOL,
        jax_wminor._UP_BWD_DECOMP,
        jax_stage_kernel_int8._INT8_STAGE,
        jax_stage_kernel_train._FUSED_TRAIN,
        jax_stage_kernel_train._TRAIN_BWD_V3,
    )
    jax_stage_kernel.set_fused_stage(fused_stage)
    jax_wminor.set_lazy_upsample(False)
    jax_wminor.set_lazy_pool(False)
    jax_wminor.set_up_bwd_decomp(False)
    jax_stage_kernel_int8.set_int8_stage(False)
    jax_stage_kernel_train.set_fused_train(fused_train)
    jax_stage_kernel_train.set_train_bwd_v3(False)
    try:
        yield
    finally:
        jax_stage_kernel.set_fused_stage(saved[0])
        jax_wminor.set_lazy_upsample(saved[1])
        jax_wminor.set_lazy_pool(saved[2])
        jax_wminor.set_up_bwd_decomp(saved[3])
        jax_stage_kernel_int8.set_int8_stage(saved[4])
        jax_stage_kernel_train.set_fused_train(saved[5])
        jax_stage_kernel_train.set_train_bwd_v3(saved[6])


def oihw(kernel_hwio) -> torch.Tensor:
    """A JAX HWIO kernel as a torch OIHW weight."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel_hwio, np.float32).transpose(3, 2, 0, 1)))


def vec(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def randomize_batch_stats(variables, seed: int = 7):
    """Random BN running statistics (numpy), so the eval affine matters."""
    g = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {
                k: (
                    (g.random(np.shape(v)) + 0.5).astype(np.float32) if k == "var"
                    else (g.normal(size=np.shape(v)) * 0.3).astype(np.float32)
                    if k == "mean" else walk(v)
                )
                for k, v in dict(node).items()
            }
        return np.asarray(node)

    return {"params": walk(variables["params"]),
            "batch_stats": walk(variables["batch_stats"])}
