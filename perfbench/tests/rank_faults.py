"""Faults planted in every rank process of a cell over several cards
(`run.execute(..., rank_setup=fault)`): each rank is a fresh spawned
process, so a fault is a function importable by name that patches the
port there."""


def skip_gradient_allreduce():
    """The exchange between cards left out: each rank steps on its own
    events' gradient. Every rank skips it: a rank that skipped alone
    would leave the others waiting in the collective."""
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    TrainVal._sum_gradients = lambda self: None


def half_batch():
    """Half of each rank's batch left out: the second half of its events
    lose their voxels, so the loss is the mean over the rest."""
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    orig = TrainVal._batch

    def half(self, blob):
        batch = orig(self, blob)
        n = batch["n_voxels"].clone()
        n[len(n) // 2:] = 0
        batch["n_voxels"] = n
        return batch
    TrainVal._batch = half


def unchanged_state():
    """A step that returns its state unchanged."""
    import torch
    from uresnet_pytorch_tpu_torch import trainval
    torch.optim.Adam.step = lambda self, closure=None: None
    trainval.commit_batch_moments = lambda m: None


def load_jax():
    """A rank that loads JAX: its `sys.modules` holds `jax` when its
    window closes."""
    import sys
    import types
    sys.modules["jax"] = types.ModuleType("jax")
