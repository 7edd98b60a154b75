"""Helpers shared by the port's parity tests (tests/test_torch_*.py):
carry weights from the JAX package to the port as numpy arrays."""
import numpy as np
import torch

from repro.checkpoint.store import _flatten_with_paths
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(2)   # the suite runs under several xdist workers


def jax_to_torch_params(jparams):
    """The JAX params as the port's tree on the CPU, via the checkpoint
    store's flat path keys."""
    return params_from_numpy(_flatten_with_paths(jparams), device="cpu")


def np32(x):
    """A JAX array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)
