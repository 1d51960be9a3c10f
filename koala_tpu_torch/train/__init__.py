# Training subsystem for the learned mask estimator: data synthesis from
# speech/noise sources, SNR + spectral losses, the AdamW training loop.
from .data import MixtureSampler
from .train import make_loss_fn, make_train_step, train, train_on_device

__all__ = ["MixtureSampler", "make_loss_fn", "make_train_step", "train", "train_on_device"]
