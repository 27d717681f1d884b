"""Operations of the port's LightGlue, from its shape (chip_smoke.py's
`lightglue_flops`): the count behind `neural.match_mfu`."""


def lightglue_ops(N: int, D: int, layers: int) -> float:
    """Floating-point operations of LightGlueNet on one pair of N keypoint
    slots (every slot computed, valid or not): per layer and set, four
    attention projections (8 N D^2) and two products (4 N^2 D) for self-
    and for cross-attention, and a message MLP 2D -> 2D -> D (12 N D^2)
    after each; then input_proj and final_proj (2 N D^2 each a set) and the
    similarity (2 N^2 D). Softmax, LayerNorm and GELU are left out."""
    per_set_layer = 2 * (8 * N * D * D + 4 * N * N * D + 12 * N * D * D)
    return 2 * layers * per_set_layer + 2 * 2 * (2 * N * D * D) + 2 * N * N * D
