"""Error model, mirroring the reference's 4-variant enum (src/lib.rs:18-28)."""


class Error(Exception):
    """Base error for benchmark.reference."""


class InvalidInstances(Error):
    """Instances provided to the verifier have the wrong shape."""


class InvalidProtocol(Error):
    """Protocol is malformed (e.g. missing query or challenge)."""

    def __init__(self, msg: str = ""):
        super().__init__(msg)


class AssertionFailure(Error):
    """A verification equation failed (carries the human-readable equation)."""

    def __init__(self, msg: str = ""):
        super().__init__(msg)


class TranscriptError(Error):
    """Proof stream is malformed (bad encoding, truncated, off-curve point)."""

    def __init__(self, msg: str = ""):
        super().__init__(msg)
