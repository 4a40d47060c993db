"""Loader-generic Fiat–Shamir transcript interface
(parity: util/transcript.rs:9-62)."""

from __future__ import annotations


class Transcript:
    def loader(self):
        raise NotImplementedError

    def squeeze_challenge(self):
        raise NotImplementedError

    def squeeze_n_challenges(self, n: int):
        return [self.squeeze_challenge() for _ in range(n)]

    def common_ec_point(self, ec_point):
        raise NotImplementedError

    def common_scalar(self, scalar):
        raise NotImplementedError


class TranscriptRead(Transcript):
    def read_scalar(self):
        raise NotImplementedError

    def read_n_scalars(self, n: int):
        return [self.read_scalar() for _ in range(n)]

    def read_ec_point(self):
        raise NotImplementedError

    def read_n_ec_points(self, n: int):
        return [self.read_ec_point() for _ in range(n)]
