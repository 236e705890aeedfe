"""Where the port's entry points build and run: on the card unless the
caller names another device (the CPU tests pass device="cpu"; a build of the
full model's shapes without storage passes device="meta")."""
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or the card for None."""
    return torch.device(DEFAULT_DEVICE if device is None else device)
