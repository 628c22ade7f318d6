"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
tensor-core rates without sparsity, at the 700 W power limit)."""
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}


def bound_s(n_bytes: float, n_ops: float, op_type: str) -> float:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and
    the operations over the type's peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S[op_type])
