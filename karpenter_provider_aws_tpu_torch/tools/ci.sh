#!/usr/bin/env bash
# One-command CI gate of the PyTorch port: generated-artifact drift, the
# port's lint, introspection smoke, subsystem smokes, the port's tests,
# bench smoke. Every step runs a module of karpenter_provider_aws_tpu_torch
# (python -m ...), from the repository root:
#
#     bash karpenter_provider_aws_tpu_torch/tools/ci.sh          # the full gate
#     bash karpenter_provider_aws_tpu_torch/tools/ci.sh --fast   # skip the bench
#     DEVICE=cpu bash karpenter_provider_aws_tpu_torch/tools/ci.sh --fast
#
# DEVICE (default cuda) is passed as --device to every smoke and to the
# bench: their Solvers run there, and without a card the default raises
# (no CPU path stands in for the card). The steps are the repository's
# own CI gate's sixteen, in its order:
#
#   1. drift  — the CRDs (gen_crds --check) and docs/reference/*.md
#               (gen_docs --check: the pages as this package renders
#               them, settings.md under its pinned SETTINGS_SEAMS); a
#               stale page prints its diff and a STALE line
#   2. lint   — the project-invariant static analysis over the whole
#               package against its own baseline (lint.run --check)
#   3. smoke  — introspection + metrics wire format (smoke_introspect)
#   4. churn  — steady-state delta solve (smoke_delta)
#   5. sharded— the 8-shard mesh, batched on DEVICE (smoke_sharded)
#   6. micro  — the device-resident microloop on the mesh
#               (smoke_microloop; legs <= 2, <= 4 after a merge)
#   7. prof   — continuous profiling (smoke_profile)
#   8. write  — the API-stratum write path (smoke_writepath)
#   9. weather— the squall on FakeClock (smoke_weather)
#  10. pool   — solver-pool failover (smoke_pool)
#  11. explain— decision explainability (smoke_explain)
#  12. handoff— two-process leader handoff (smoke_handoff)
#  13. consol — batched consolidation (smoke_consolidation)
#  14. headroom— the saturation observatory (smoke_headroom)
#  15. tests  — the port's tests (tests/test_torch_*.py, not slow); they
#               hold the port against the JAX package, so this step runs
#               where JAX is installed
#  16. bench  — the port's bench --smoke: one fast config through the
#               real harness

set -euo pipefail
cd "$(dirname "$0")/../.."

DEVICE=${DEVICE:-cuda}
PY=${PYTHON:-python}
FAST=0
[ "${1:-}" = "--fast" ] && FAST=1
PKG=karpenter_provider_aws_tpu_torch

echo "=== ci [1/16] generated-artifact drift ==="
$PY -m $PKG.tools.gen_crds --check
$PY -m $PKG.tools.gen_docs --check
echo "drift: clean"

echo "=== ci [2/16] lint (project-invariant static analysis) ==="
$PY -m $PKG.tools.lint.run --check

echo "=== ci [3/16] introspection smoke + metrics lint ==="
$PY -m $PKG.tools.smoke_introspect --device "$DEVICE"

echo "=== ci [4/16] steady-state delta churn smoke ==="
$PY -m $PKG.tools.smoke_delta --device "$DEVICE"

echo "=== ci [5/16] sharded mesh smoke ==="
$PY -m $PKG.tools.smoke_sharded --device "$DEVICE"

echo "=== ci [6/16] device-resident microloop smoke ==="
$PY -m $PKG.tools.smoke_microloop --device "$DEVICE"

echo "=== ci [7/16] continuous-profiling smoke ==="
$PY -m $PKG.tools.smoke_profile --device "$DEVICE"

echo "=== ci [8/16] write-path smoke ==="
$PY -m $PKG.tools.smoke_writepath --device "$DEVICE"

echo "=== ci [9/16] adversarial-weather smoke ==="
$PY -m $PKG.tools.smoke_weather --device "$DEVICE"

echo "=== ci [10/16] solver-pool failover smoke ==="
$PY -m $PKG.tools.smoke_pool --device "$DEVICE"

echo "=== ci [11/16] decision-explainability smoke ==="
$PY -m $PKG.tools.smoke_explain --device "$DEVICE"

echo "=== ci [12/16] zero-downtime handoff smoke ==="
$PY -m $PKG.tools.smoke_handoff --device "$DEVICE"

echo "=== ci [13/16] batched consolidation smoke ==="
$PY -m $PKG.tools.smoke_consolidation --device "$DEVICE"

echo "=== ci [14/16] saturation-headroom smoke ==="
$PY -m $PKG.tools.smoke_headroom --device "$DEVICE"

echo "=== ci [15/16] the port's tests ==="
$PY -m pytest tests/test_torch_*.py -q -m 'not slow' \
    --continue-on-collection-errors -p no:cacheprovider

if [ "$FAST" = 1 ]; then
    echo "=== ci [16/16] bench smoke: SKIPPED (--fast) ==="
else
    echo "=== ci [16/16] bench smoke ==="
    $PY -m $PKG.bench --device "$DEVICE" --smoke
fi

echo "ci gate: OK"
