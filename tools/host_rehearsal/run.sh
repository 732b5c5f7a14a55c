#!/bin/sh
# Host rehearsal of src/repro_torch/kernels/csrc/reveal.cu: g++ runs every
# reveal entry point on small shapes, each block as host threads, and
# holds each cell to the dense maxsim per-cell arithmetic bit for bit.
# It exercises the barrier structure, the chunk loop and both block shapes
# on a machine without nvcc or a card; it says nothing of speed.
#
#   sh tools/host_rehearsal/run.sh        # from the repository root
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
sed -e "$SMEM" -e 's/kernel<<<\(.*\)>>>(/host_launch(kernel, \1, /' \
    "$CSRC/reveal.cu" > "$WORK/src/reveal.cpp"
grep -q host_launch "$WORK/src/reveal.cpp"
grep -q "smem = smem_host" "$WORK/src/reveal.cpp"
g++ -std=c++20 -O1 -ffp-contract=off -fno-strict-aliasing -pthread \
    -I"$WORK/inc" -I"$WORK" -include "$HERE/cuda_host.h" \
    -o "$WORK/rehearse" "$HERE/reveal_main.cpp"
"$WORK/rehearse"
