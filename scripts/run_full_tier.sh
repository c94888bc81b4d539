#!/usr/bin/env bash
# Full-tier test run (RUN_SLOW=1) with the heavy TP/VLM slow files
# isolated into their own pytest subprocesses.
#
# Why: the in-process XLA CPU backend on this 1-core box intermittently
# SEGFAULTs inside backend_compile when one pytest process accumulates
# many large TP-sharded compilations (a round-4 flake:
# test_tp_hosted_verifier_with_draft crashed once, re-ran clean 24/24 —
# same family as the 2x2-mesh rendezvous aborts). Per-file isolation
# bounds the blast radius: a crash fails ONE file's phase visibly
# instead of aborting the whole tier, and fresh processes avoid the
# compile-state accumulation that seems to trigger it.
#
# Usage: scripts/run_full_tier.sh   (from anywhere; ~30 min)
# Exit code: non-zero if ANY phase fails.
set -u
cd "$(dirname "$0")/.."

# Slow files that build TP meshes / full LLaVA stacks in-process.
ISOLATE=(
    tests/test_tpu_verifier.py
    tests/test_vlm_tp.py
    tests/test_multihost.py
)

deselect=()
for f in "${ISOLATE[@]}"; do deselect+=(--ignore "$f"); done

fail=0
echo "=== phase 1: main suite (full tier minus isolated files) ==="
RUN_SLOW=1 python -m pytest tests/ -q -p no:cacheprovider "${deselect[@]}" || fail=1

for f in "${ISOLATE[@]}"; do
    echo "=== phase 2: $f (isolated subprocess) ==="
    RUN_SLOW=1 python -m pytest "$f" -q -p no:cacheprovider || fail=1
done

if [ "$fail" -ne 0 ]; then
    echo "FULL TIER: FAILURES (see above)"
else
    echo "FULL TIER: all phases green"
fi
exit "$fail"
