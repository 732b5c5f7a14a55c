#!/bin/sh
# Host rehearsal of the CUDA sources in src/repro_torch/kernels/csrc: g++
# runs every entry point of reveal.cu and maxsim.cu on small shapes, each
# block as host threads, and holds each cell to a serial fmaf chain bit for
# bit. It exercises the barrier structure, the chunk loops and the block
# shapes on a machine without nvcc or a card; it says nothing of speed.
#
#   sh tools/host_rehearsal/run.sh            # both sources (~75 s)
#   sh tools/host_rehearsal/run.sh maxsim     # maxsim.cu alone (seconds)
#   sh tools/host_rehearsal/run.sh reveal     # reveal.cu alone
#
# cp.async becomes a synchronous copy (async_copy.cuh here), shared memory a
# host buffer, and the <<<...>>> launch a loop over blocks (cuda_host.h).
set -e
HERE=$(cd "$(dirname "$0")" && pwd)
CSRC=$HERE/../../src/repro_torch/kernels/csrc
WORK=$(mktemp -d "${TMPDIR:-/tmp}/host_rehearsal.XXXXXX")
trap 'rm -rf "$WORK"' EXIT
mkdir -p "$WORK/src" "$WORK/inc"
: > "$WORK/inc/cuda_bf16.h"
: > "$WORK/inc/cuda_runtime.h"
cp "$CSRC/common.cuh" "$HERE/async_copy.cuh" "$WORK/src/"
SMEM='s/extern __shared__ __align__(16) unsigned char smem\[\];'
SMEM="$SMEM/unsigned char* smem = smem_host;/"
for NAME in ${*:-reveal maxsim}; do
  sed -e "$SMEM" \
      -e 's/kernel<<<\(.*\)>>>(/host_launch(kernel, \1, /' \
      "$CSRC/$NAME.cu" > "$WORK/src/$NAME.cpp"
  grep -q host_launch "$WORK/src/$NAME.cpp"
  if grep -q "extern __shared__" "$WORK/src/$NAME.cpp"; then
    echo "$NAME.cu: a shared-memory declaration the rehearsal cannot map"
    exit 1
  fi
  g++ -std=c++20 -O1 -ffp-contract=off -fno-strict-aliasing -pthread \
      -I"$WORK/inc" -I"$WORK" -include "$HERE/cuda_host.h" \
      -o "$WORK/$NAME" "$HERE/${NAME}_main.cpp"
  "$WORK/$NAME"
done
