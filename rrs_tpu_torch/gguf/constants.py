"""GGUF/GGML enums and block-format size tables (copied from the JAX package, host-only).

Type ids follow the reference enum (ggml/include/ggml.h:389-434) so GGUF files
interoperate in both directions, including the fork's TCQ4_K32 (id 42).
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39
    Q4_K_RRS = 40
    Q4_K_RRS_ACT = 41
    TCQ4_K32 = 42


# (block_size_elements, type_size_bytes) per type — mirrors the ggml type
# traits table (ggml/src/ggml.c:600-900). TCQ4: one 1184-byte tile covers
# 8 rows x 256 elements => 148 bytes per 256 elements of one row
# (ggml/include/ggml.h:470, type_size 148, blck 256).
BLOCK_SIZES: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),
    GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22),
    GGMLType.Q5_1: (32, 24),
    GGMLType.Q8_0: (32, 34),
    GGMLType.Q8_1: (32, 36),
    GGMLType.Q2_K: (256, 84),
    GGMLType.Q3_K: (256, 110),
    GGMLType.Q4_K: (256, 144),
    GGMLType.Q5_K: (256, 176),
    GGMLType.Q6_K: (256, 210),
    GGMLType.Q8_K: (256, 292),
    GGMLType.IQ4_NL: (32, 18),
    GGMLType.IQ4_XS: (256, 136),
    GGMLType.IQ2_XXS: (256, 66),
    GGMLType.IQ2_XS: (256, 74),
    GGMLType.IQ2_S: (256, 82),
    GGMLType.IQ3_XXS: (256, 98),
    GGMLType.IQ3_S: (256, 110),
    GGMLType.IQ1_S: (256, 50),
    GGMLType.IQ1_M: (256, 56),
    GGMLType.TQ1_0: (256, 54),
    GGMLType.TQ2_0: (256, 66),
    GGMLType.MXFP4: (32, 17),
    GGMLType.TCQ4_K32: (256, 148),
}


def row_size(ggml_type: GGMLType, n_elements: int) -> int:
    blck, tsize = BLOCK_SIZES[ggml_type]
    assert n_elements % blck == 0, (ggml_type, n_elements)
    return n_elements // blck * tsize


# Keys used by the fork for reorder metadata (src/llama-quant.cpp:840-855).
KEY_TCQ4_REORDER_ENABLED = "tcq4.reorder.enabled"


def tcq4_perm_key(tensor_name: str) -> str:
    return f"tcq4.{tensor_name}.perm"
