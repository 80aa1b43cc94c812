// The tile kernels T1-T4 (tile_kernels.cu) for tiles of 512 rows: one
// thread-block cluster of 4 CTAs a tile, a library of its own, built beside
// the others by pyflwdir_torch/kernels.py.
#define PF_TILE_G 4
#include "tile_kernels.cu"
