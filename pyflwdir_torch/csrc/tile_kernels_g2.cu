// The tile kernels T1-T4 (tile_kernels.cu) for tiles of 256 rows: one
// thread-block cluster of 2 CTAs a tile, a library of its own, built beside
// the others by pyflwdir_torch/kernels.py.
#define PF_TILE_G 2
#include "tile_kernels.cu"
