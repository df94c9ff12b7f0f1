"""The one generator of vocoder traffic, driven by a mix's parameters
(``portbench/traffic/<name>.json``).

Utterance lengths follow the mix's distribution (a normal clipped to the
corpus's range). A round is ``batches_per_round`` calls of ``batch``
utterances each, every call inside one ``frame_bucket`` bucket; the
buckets get calls in proportion to the length distribution's mass in them
(largest remainders, at least one call for every bucket with mass), and
a bucket's lengths sit at evenly spaced quantiles of the distribution
inside it, dealt to its calls in turn. The buckets follow each other in
one fixed sequence that spreads each bucket's calls evenly over the round
(smooth weighted round robin), so every stretch of calls carries the mix
in proportion, however few calls a window holds. So every seed runs the
same calls and lengths in the same buckets' sequence: the seed picks
which call of a bucket fills each of its places in each round, draws the
mels and the noise, and picks the utterances the check compares.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

# streams drawn from a run's seed
WEIGHTS, MELS, ORDER, NOISE, SAMPLE, WARM, PRIME = range(1, 8)


def seed_for(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run: any whole ``seed`` (large or
    negative) with the stream's indices."""
    entropy = [int(seed) % (1 << 64)] + [int(s) for s in stream]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Mix:
    """A traffic mix at a configuration's sample rate and hop."""

    def __init__(self, spec: dict, sample_rate: int, hop: int):
        lengths = spec["lengths"]
        if lengths["distribution"] != "normal_clipped":
            raise ValueError(f"unknown length distribution "
                             f"{lengths['distribution']!r}")
        self.dist = NormalDist(float(lengths["mean_s"]), float(lengths["std_s"]))
        self.lo, self.hi = float(lengths["min_s"]), float(lengths["max_s"])
        self.rate = sample_rate / hop            # frames a second
        self.bucket = int(spec["frame_bucket"])
        self.batch = int(spec["batch"])
        self.per_round = int(spec["batches_per_round"])
        self.calls = self.round_calls()
        self.slots = self._slots()

    def frames(self, seconds: float) -> int:
        return int(round(seconds * self.rate))

    def padded(self, frames: int) -> int:
        return -(-frames // self.bucket) * self.bucket

    def _cdf(self, seconds: float) -> float:
        """The clipped distribution's CDF: the mass below ``min_s`` sits at
        ``min_s``, the mass above ``max_s`` at ``max_s``."""
        if seconds < self.lo:
            return 0.0
        if seconds >= self.hi:
            return 1.0
        return self.dist.cdf(seconds)

    def _quantile(self, u: float) -> float:
        return min(self.hi, max(self.lo, self.dist.inv_cdf(
            min(max(u, 1e-12), 1 - 1e-12))))

    def bucket_mass(self) -> dict:
        """{padded frames: probability} of the buckets the lengths reach."""
        top = self.padded(self.frames(self.hi))
        mass = {}
        for edge in range(self.bucket, top + 1, self.bucket):
            low = self._cdf((edge - self.bucket + 0.5) / self.rate)
            high = self._cdf((edge + 0.5) / self.rate)
            if high > low:
                mass[edge] = high - low
        return mass

    def round_calls(self) -> list:
        """The calls of one round: [frames of each utterance], grouped by
        bucket in increasing padded length. The same for every seed."""
        mass = self.bucket_mass()
        shares = {edge: self.per_round * p for edge, p in mass.items()}
        quota = {edge: max(1, int(math.floor(v))) for edge, v in shares.items()}
        order = sorted(shares, key=lambda e: shares[e] - quota[e],
                       reverse=True)
        while sum(quota.values()) < self.per_round:
            quota[order.pop(0)] += 1
        while sum(quota.values()) > self.per_round:
            quota[max(quota, key=quota.get)] -= 1
        calls = []
        for edge in sorted(quota):
            n = quota[edge] * self.batch
            low = self._cdf((edge - self.bucket + 0.5) / self.rate)
            high = self._cdf((edge + 0.5) / self.rate)
            lengths = [min(edge, max(edge - self.bucket + 1, self.frames(
                self._quantile(low + (j + 0.5) / n * (high - low)))))
                for j in range(n)]
            for c in range(quota[edge]):
                calls.append(lengths[c::quota[edge]])
        return calls

    def _slots(self) -> list:
        """The bucket of each place of a round: each bucket's share of the
        places spread evenly (smooth weighted round robin, ties to the
        shorter bucket)."""
        counts = {}
        for frames in self.calls:
            edge = self.padded(max(frames))
            counts[edge] = counts.get(edge, 0) + 1
        credit = dict.fromkeys(counts, 0)
        slots = []
        for _ in range(self.per_round):
            for edge in counts:
                credit[edge] += counts[edge]
            pick = max(credit, key=lambda e: (credit[e], -e))
            credit[pick] -= self.per_round
            slots.append(pick)
        return slots

    def order(self, seed: int, round_index: int) -> list:
        """The round's calls (indices into ``calls``) in round
        ``round_index``: the fixed sequence of buckets, each bucket's calls
        in an order drawn from the seed."""
        rng = np.random.default_rng(seed_for(seed, ORDER, round_index))
        queues = {}
        for i, frames in enumerate(self.calls):
            queues.setdefault(self.padded(max(frames)), []).append(i)
        queues = {edge: list(rng.permutation(q)) for edge, q in
                  sorted(queues.items())}
        return [int(queues[edge].pop()) for edge in self.slots]

    def warm_calls(self) -> list:
        """The index of the first call of each distinct padded shape."""
        seen, out = set(), []
        for i, frames in enumerate(self.calls):
            shape = (len(frames), self.padded(max(frames)))
            if shape not in seen:
                seen.add(shape)
                out.append(i)
        return out
