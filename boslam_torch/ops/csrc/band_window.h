// The band route's window in shared memory (band_cholesky.cuh): the numbers
// from which both the kernel's launch size (band::smem_bytes) and the route
// rule (ops/cholesky.py band_smem_bytes, which reads them from this file)
// are derived.  Bytes = 4 ((bt + 1)^2 + SPARE_TILES) TILE LD + 4 n.
#pragma once

#define BOSLAM_BAND_LD 36              // floats in a window tile's row: TILE + 4
#define BOSLAM_BAND_SPARE_TILES 2      // tiles beside the window: two tile inverses
#define BOSLAM_BAND_SMEM_LIMIT 232448  // bytes one H100 block may opt into (227 KB)
