#!/usr/bin/env bash
# Joint-calling STRling pipeline: extract per sample -> merge -> call per
# sample against the merged bounds -> cohort outliers.
# (Equivalent of the reference's pipelines/strling-joint.groovy.)
#
# Usage: strling-joint.sh REF.fasta OUT_DIR BAM [BAM...]
# Env:   STRLING, LOCI as in strling-individual.sh
#        JOBS=N    parallel extract fan-out (default 1)
#        NGPU=N    cards to spread the extract jobs over (default: all that
#                  nvidia-smi lists; 0 runs without a card)
set -euo pipefail

REF=$1; OUT=$2; shift 2
STRLING=${STRLING:-"python -m strling_tpu.cli"}
JOBS=${JOBS:-1}
NGPU=${NGPU:-$(nvidia-smi -L 2>/dev/null | grep -c '^GPU' || true)}
# A JAX process reserves most of its card's memory when it starts, so each
# concurrent extract gets a card of its own; where JOBS exceeds the cards,
# the jobs on one card split 90% of its memory between them.
PER_CARD=1
if [ "$NGPU" -gt 0 ] && [ "$JOBS" -gt "$NGPU" ]; then
  PER_CARD=$(( (JOBS + NGPU - 1) / NGPU ))
fi
mkdir -p "$OUT"

STRFILE="$OUT/$(basename "$REF").str"
[ -e "$STRFILE" ] || $STRLING index -g "$STRFILE" "$REF"

extract_one() {
  BAM=$1; SLOT=$2
  S=$(basename "$BAM" .bam)
  if [ "$NGPU" -gt 0 ]; then
    export CUDA_VISIBLE_DEVICES=$(( SLOT % NGPU ))
    if [ "$PER_CARD" -gt 1 ]; then
      export XLA_PYTHON_CLIENT_MEM_FRACTION=$(awk "BEGIN { printf \"%.2f\", 0.9 / $PER_CARD }")
    fi
  fi
  $STRLING extract -f "$REF" -g "$STRFILE" "$BAM" "$OUT/$S.bin"
}
export -f extract_one 2>/dev/null || true

BINS=()
for BAM in "$@"; do
  S=$(basename "$BAM" .bam)
  BINS+=("$OUT/$S.bin")
done

i=0
for BAM in "$@"; do
  extract_one "$BAM" $((i % JOBS)) &
  i=$((i+1)); [ $((i % JOBS)) -eq 0 ] && wait
done
wait

$STRLING merge -f "$REF" ${LOCI:+-l "$LOCI"} -o "$OUT/joint" "${BINS[@]}"

for BAM in "$@"; do
  S=$(basename "$BAM" .bam)
  $STRLING call -f "$REF" -b "$OUT/joint-bounds.txt" -o "$OUT/$S" "$BAM" "$OUT/$S.bin"
done

$STRLING outliers \
  --genotypes "$OUT"/*-genotype.txt \
  --unplaced "$OUT"/*-unplaced.txt \
  --out "$OUT/cohort."
