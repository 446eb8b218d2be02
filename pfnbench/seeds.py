"""The streams drawn from ``--seed``: each its own generator seed."""

WEIGHTS, DATA, SCORE = 1, 2, 3


def derive(seed: int, stream: int) -> int:
    return (int(seed) * 1_000_003 + stream) % (2**63 - 1)
