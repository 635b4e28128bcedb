"""Router logits with signed zeros, for the top-k order tests: the
reference's serving path (``lax.top_k``) orders -0.0 below +0.0, and the
port's router gate follows it. numpy only, so that the CUDA tests (which
import no JAX) share the rows with the CPU tests."""
import numpy as np

# the row on which lax.top_k picks experts [1, 3] at k = 2 and an
# iterative max that ties the zeros picks [0, 1]
ZEROS_ROW = np.array([[-0.0, 0.0, -0.0, 0.0]], np.float32)


def signed_zero_rows(seed: int, t: int, e: int, k: int) -> np.ndarray:
    """[T, E] f32 logits. Row 0: zeros of random sign only. Every other
    row: fewer than k positive logits (on a coarse grid, so that they tie
    too), then zeros of alternating sign across the k-th place (at least
    three where E allows), then negatives, at shuffled positions."""
    rng = np.random.default_rng(seed)
    z = np.empty((t, e), np.float32)
    for i in range(t):
        if i == 0:
            row = np.where(rng.random(e) < 0.5, -0.0, 0.0)
        else:
            n_pos = int(rng.integers(0, k))
            n_zero = int(rng.integers(min(e - n_pos, k - n_pos + 3),
                                      e - n_pos + 1))
            signs = np.where(np.arange(n_zero) % 2 == 0, -0.0, 0.0)
            row = np.concatenate([
                rng.integers(1, 3, n_pos).astype(np.float32),
                rng.permutation(signs),
                -rng.integers(1, 3, e - n_pos - n_zero).astype(np.float32)])
            row = row[rng.permutation(e)]
        z[i] = row
    return z


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal as f32 bit patterns: -0.0 differs from +0.0."""
    return np.array_equal(np.asarray(a, np.float32).view(np.int32),
                          np.asarray(b, np.float32).view(np.int32))
