// The bf16 flash kernel's parent design, p split into two bf16 terms
// before P V (p_hi + p_lo, two wgmma a 16-key step): built and timed by
// chip_smoke.py phase 4 beside the package's three-term kernel, and held
// against an f64 answer by tools/flash_p_split.py.  No wrapper of the
// package calls it.  Its C entries are the package's
// (flash_attention_f32, flash_attention_bf16), in a library of its own.

#define FLASH_P_TERMS 2
#include "flash_attention.cu"
