"""The port's kernel layer: CUDA C++ kernels for Hopper (``csrc/``) behind
wrappers that run the kernel on CUDA tensors and its plain PyTorch version
on CPU tensors — and never fall back from one to the other.

``ENGINE_NAMES`` is the single table mapping the reference's engine names to
the port's: the reference's jnp/XLA paths become ``"torch"`` (plain tensor
ops, on whatever device the data lies) and its Pallas kernels ``"cuda"``.
"""
from __future__ import annotations

import torch

__all__ = ["ENGINE_NAMES", "ENGINES", "PREDICATE_ENGINES", "launch_counts",
           "reset_launch_counts", "require_kernel_operand"]

# reference engine name -> port engine name
ENGINE_NAMES = {"xla": "torch", "jnp": "torch", "pallas": "cuda",
                "auto": "auto"}
ENGINES = ("torch", "cuda")                   # executor (compaction) engines
PREDICATE_ENGINES = ("torch", "cuda", "auto")

# Launches of each kernel wrapper: one is added where the wrapper launches
# its kernel, and nowhere else (plain-version calls do not count).
launch_counts = {"predicate_bitset": 0, "filter_compact": 0, "bitset_op": 0,
                 "segmented_scan": 0, "flash_attention": 0,
                 "filter_compact_mask": 0, "hash_partition_plan": 0,
                 "flash_decode": 0, "flash_decode_lse": 0,
                 "flash_attention_bwd": 0,
                 # B6's fp32 kernels (csrc/swa_attention.cu's flash_f32 and
                 # csrc/swa_backward.cu), counted in flash_attention and
                 # flash_attention_bwd too
                 "flash_attention_f32": 0, "flash_attention_bwd_f32": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def require_kernel_operand(t: torch.Tensor, name: str,
                           dtypes=(torch.int32, torch.float32),
                           contiguous: bool = True) -> None:
    """A kernel operand must be a CUDA tensor of one of ``dtypes`` (by
    default the 4-byte int32/float32 of B1-B5) and, unless the kernel takes
    strides (``contiguous=False``), contiguous."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: kernel operand must be a CUDA tensor")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name}: kernel operand must be {names}, "
                         f"got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: kernel operand must be contiguous")
