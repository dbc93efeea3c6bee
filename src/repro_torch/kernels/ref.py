"""The plain PyTorch version of every CUDA kernel (the correctness
contract).  On the CPU each one is held against the reference's Pallas path;
on the card each kernel is held against it, bit for bit (B6, attention,
within the reference's fp32/bf16 tolerances: it sums in another order).  Each lives beside
its kernel; this module gathers them under the reference's names.
"""
from __future__ import annotations

from repro_torch.kernels.bitset_ops import bitset_op_plain as bitset_op_ref
# a whole cohort expression a launch: the reference chains bitset_op_ref
from repro_torch.kernels.bitset_ops import bitset_expr_plain
from repro_torch.kernels.filter_compact import \
    filter_compact_mask_plain as filter_compact_mask_ref
from repro_torch.kernels.filter_compact import \
    filter_compact_plain as filter_compact_ref
from repro_torch.kernels.hash_partition import \
    hash_partition_plan_plain as hash_partition_plan_ref
from repro_torch.kernels.predicate import \
    predicate_bitset_plain as predicate_bitset_ref
# the Pallas kernel's semantics, which differ from the reference's sequential
# oracle ``segmented_scan_ref`` beyond ±2e9 (ROADMAP C8) — hence its own name
from repro_torch.kernels.segment_scan import segmented_scan_plain
from repro_torch.kernels.swa_attention import \
    flash_swa_attention_plain as attention_ref
# B6's gradient, which has no Pallas kernel (the reference differentiates
# its XLA attention)
from repro_torch.kernels.swa_attention import \
    flash_swa_attention_backward_plain as attention_bwd_ref

__all__ = ["attention_ref", "attention_bwd_ref", "bitset_op_ref", "bitset_expr_plain",
           "filter_compact_mask_ref",
           "filter_compact_ref", "hash_partition_plan_ref",
           "predicate_bitset_ref", "segmented_scan_plain"]
