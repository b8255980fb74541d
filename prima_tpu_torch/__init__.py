"""prima_tpu_torch: the PyTorch/CUDA port of prima_tpu.

It mirrors prima_tpu's module layout and imports neither jax nor prima_tpu.
Entry points run on the first CUDA device unless the caller asks for the
CPU (`device="cpu"`, `--device cpu`); without a GPU they raise instead of
falling back.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, CUDA by default; raises when CUDA is
    asked for and there is no GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to run on the CPU")
    return dev
