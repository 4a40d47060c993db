"""Proofs that reached a verdict (succinct verify and batch decide, the
verdict on the host) over the whole window, host clock."""


def read(run):
    return run.window.proofs() / run.window.length_s
