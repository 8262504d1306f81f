"""The cheapest-offering finalization kernel (``csrc/offering_argmin.cu``).

``MATCH`` is a part of its name in the profiler's trace; ``PATCH`` the
module attribute through which the pack calls it, which the traced window
wraps to note each call's bytes. ``nbytes`` is the least a call must move:
each input read once (the type and cell masks as bytes, the float32 price
panel) and each output (a float32 value and an int32 index per bin)
written once.
"""

MATCH = "cheapest_offering"
PATCH = ("karpenter_provider_aws_tpu_torch.ops.binpack", "cheapest_offering")


def nbytes(tmask, zcmask, price) -> int:
    B, T = tmask.shape
    ZC = zcmask.shape[1]
    return B * T + B * ZC + T * ZC * 4 + B * 8
