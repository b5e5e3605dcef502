"""Sinkhorn's work: log-scores S (B, n+1, m+1), log-marginals mu (B, n+1)
and nu (B, m+1) read once and P written once; per entry, each of the
``iterations`` sweeps takes a row and a column log-sum-exp of 4 operations
(max, subtract, exp, add), and the last step an add and an exp."""


def work(batch: int, n: int, m: int, iterations: int) -> tuple[float, float]:
    entries = batch * (n + 1) * (m + 1)
    nbytes = 4 * (2 * entries + batch * (n + 1) + batch * (m + 1))
    return entries * (iterations * 2 * 4 + 2), nbytes
