"""graftlint: the project-invariant static-analysis suite, for this
package.

The counterpart of the repository's ``tools/lint/``: the same seven
rules over ``karpenter_provider_aws_tpu_torch/**/*.py``, with a baseline
of its own (``baseline.json`` here, each entry with its reason).

Zero-dependency AST checkers for the correctness properties the repo's
regression tests bled for but convention alone enforces (docs/reference/
linting.md): clock discipline (no raw wall-clock calls outside
utils/clock.py), lock discipline (no blocking calls under an
instrumented lock; stats() never takes the solve lock), determinism
(weather/ and solver/ never touch the global RNG or wall time), the
frozen-envelope contract (watch handlers never mutate event objects
without a deepcopy thaw), and metrics discipline (every karpenter_*
series used in code is declared in metrics.py and documented).

    python -m karpenter_provider_aws_tpu_torch.tools.lint.run --check

The runtime half — the lock-order witness that turns the same lock
discipline into a standing deadlock detector — lives in
karpenter_provider_aws_tpu_torch/introspect/contention.py.
"""
