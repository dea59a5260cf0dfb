"""The port's kernels by the names their launches carry in a device
trace, grouped as the per-layer metrics count them."""

# K1 seed extension, K2 final global alignment, K2b its traceback,
# K3 mate rescue
DP = ("sw_extend_kernel", "sw_global_kernel", "traceback_kernel",
      "sw_local_kernel")
# K4a two-pointer SMEMs, K4b exhaustive fallback, K4c strategy-1 seeds,
# K5 SA walk (and its lookup entry), K9 compaction
SEED = ("twoptr_kernel", "exhaustive_kernel", "strategy1_kernel",
        "sa_walk_kernel", "sa_lookup_kernel", "compact_kernel")


def device_s(profiles, names) -> float:
    """Device seconds of the kernels whose trace name holds one of
    ``names``, summed over the profiles."""
    return sum(s for pr in profiles for k, (s, _) in
               pr.get("kernels", {}).items() if any(n in k for n in names))
