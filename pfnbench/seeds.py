"""The generator seeds of a run: one for each stream drawn from ``--seed``,
and the training window's, drawn from none."""

WEIGHTS, DATA, SCORE, WINDOW = 1, 2, 3, 4


def derive(seed: int, stream: int) -> int:
    return (int(seed) * 1_000_003 + stream) % (2**63 - 1)


# The training window's generator seed, the same for every ``--seed``. An
# update's work follows the sep it draws, so a window drawn from the seed
# would let the seed set the rate. Of the streams derive(k, WINDOW), k < 64,
# this is the one whose mean decoded rows (bptt - sep) in the Fig-3a cell's
# first 50, 75, 100, 150, 200, 300 and 400 updates lie nearest the mixture's
# mean, 415.1 rows (within 7.6 % of it at each; the median stream: 19 %).
WINDOW_DATA = derive(8, WINDOW)
