"""Operations and bytes one implicit-ALS sweep needs (both half-steps),
over the interactions each side's lists keep (``kept_u``, ``kept_i``:
each row's interactions up to the configuration's cap), not the padding
a program adds.

A half-step solving ``n`` rows against a fixed side of ``m`` rows with
``kept`` interactions:

- the weighted products F_u' diag(w) F_u: 2 * kept * K^2;
- the right-hand sides F_u' c: 2 * kept * K;
- the fixed side's gram F'F: 2 * m * K^2;
- a Cholesky factorization a row, K^3 / 3, and its two triangular
  solves, 2 * K^2.

Bytes: the lists read once (an int32 index and an f32 value an
interaction), the fixed factors read once and the solved factors written
once, f32.
"""


def half_step(n: int, m: int, kept: int, k: int) -> tuple[float, float]:
    ops = 2.0 * kept * k * k + 2.0 * kept * k + 2.0 * m * k * k + n * (k ** 3 / 3.0 + 2.0 * k * k)
    n_bytes = 8.0 * kept + 4.0 * m * k + 4.0 * n * k
    return ops, n_bytes


def sweep(users: int, items: int, kept_u: int, kept_i: int, k: int) -> tuple[float, float]:
    ou, bu = half_step(users, items, kept_u, k)
    oi, bi = half_step(items, users, kept_i, k)
    return ou + oi, bu + bi
