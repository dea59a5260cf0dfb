"""The port's hybrid router (``cli._primed_iter``, the reference's
lariat_tpu/cli.py primed_iter) on stand-in engines: saturation
host-routing, dormancy (the 45 s first-batch rule and
LARIAT_PRIME_MIN_FRAC), the server's fixed batch (LARIAT_PRIME_BATCH), and
the end of input (queued batches cancelled, the tail grace -- set, and the
reference's formula when LARIAT_PRIME_TAIL_GRACE is unset -- then the
abort with its batch host-routed). In every case each item is yielded exactly
once, and primed plus host-routed pairs are all the pairs. A raising
engine ends the CLI run with an error."""

import threading
import time

import pytest

from lariat_tpu_torch import cli
from lariat_tpu_torch.align.batch_engine import PrimeAborted
from lariat_tpu_torch.config import RFAConfig

from test_torch_cli import _inputs


class _Engine:
    """A stand-in that primes at once, or (``hold``) waits for ``go`` and
    raises PrimeAborted when ``abort_prime`` is set meanwhile; ``batches``
    is the pair count of every batch it was given, in the order the router
    made them (the threads may start them in another)."""

    def __init__(self, hold=False, path=None):
        self.go = threading.Event()
        if not hold:
            self.go.set()
        self.abort_prime = False
        self._log = []
        self.done = threading.Event()
        if path:
            self.path = path

    @property
    def batches(self):
        # a batch's first pair is "r<item>.0": items are numbered in order
        return [n for _, n in sorted(self._log)]

    def prime_regions(self, recs, score_delta):
        self._log.append((int(recs[0][1:].split(".")[0]), len(recs)))
        while not self.go.wait(0.01):
            if self.abort_prime:
                raise PrimeAborted()
        self.done.set()
        return [("primed", r) for r in recs]


def _items(sizes):
    return [([f"r{i}.{k}" for k in range(n)], True)
            for i, n in enumerate(sizes)]


def _run(items, eng, n_prime, feed=None):
    """(seqs in yield order, primed items, feed stats) of one feed."""
    stats = {"primed_pairs": 0, "host_pairs": 0}
    seqs, primed = [], []
    for seq, item in cli._primed_iter(feed or iter(items), eng, RFAConfig(),
                                      n_prime, stats):
        seqs.append(seq)
        if len(item) == 3:
            assert item[2] == [("primed", r) for r in item[0]]
            primed.append(seq)
    assert sorted(seqs) == list(range(len(items)))       # each item once
    n = sum(len(it[0]) for it in items)
    assert stats["primed_pairs"] + stats["host_pairs"] == n
    assert stats["primed_pairs"] == sum(len(items[s][0]) for s in primed)
    return seqs, primed, stats


def _target(monkeypatch, n):
    monkeypatch.setattr(cli, "_batch_target", lambda rate, fixed=None: n)


def test_saturation_host_routes(monkeypatch):
    """One priming thread held busy by the first batch: every later batch
    goes to the host; the held batch lands within the tail grace."""
    _target(monkeypatch, 2)
    monkeypatch.setenv("LARIAT_PRIME_TAIL_GRACE", "60")
    eng = _Engine(hold=True)
    items = _items([1] * 20)

    def feed():
        yield from items
        eng.go.set()             # the device finishes at the end of input

    _, primed, stats = _run(items, eng, 1, feed())
    assert primed == [0, 1] and eng.batches == [2]
    assert stats == {"primed_pairs": 2, "host_pairs": 18}


class _Clock:
    sleep = staticmethod(time.sleep)

    def __init__(self):
        self.t = time.time()

    def time(self):
        return self.t


def test_dormant_after_45s_without_a_batch(monkeypatch, capsys):
    _target(monkeypatch, 2)
    monkeypatch.setenv("LARIAT_PRIME_TAIL_GRACE", "60")
    clock = _Clock()
    monkeypatch.setattr(cli, "time", clock)
    eng = _Engine(hold=True)
    items = _items([1] * 10)

    def feed():
        yield from items[:2]
        clock.t += 46.0          # the first batch is still priming
        yield from items[2:]
        eng.go.set()

    _, primed, stats = _run(items, eng, 4, feed())
    assert primed == [0, 1] and eng.batches == [2]
    assert stats["host_pairs"] == 8
    assert capsys.readouterr().out.count("device priming dormant") == 1


def test_dormant_below_min_frac(monkeypatch, capsys):
    """Once a batch has landed, a device adding less than
    LARIAT_PRIME_MIN_FRAC of the host's rate goes dormant for the rest of
    the run."""
    _target(monkeypatch, 2)
    monkeypatch.setenv("LARIAT_PRIME_MIN_FRAC", "1e12")
    eng = _Engine(hold=True)
    items = _items([1] * 12)

    def feed():
        yield from items[:4]     # batch 0 primes, batch 1 host-routes
        eng.go.set()
        assert eng.done.wait(10)
        time.sleep(0.05)
        yield from items[4:]

    _, primed, stats = _run(items, eng, 1, feed())
    assert primed == [0, 1] and eng.batches == [2]
    assert stats == {"primed_pairs": 2, "host_pairs": 10}
    assert "device priming dormant" in capsys.readouterr().out


def test_min_frac_zero_never_dormant(monkeypatch):
    _target(monkeypatch, 2)
    monkeypatch.setenv("LARIAT_PRIME_MIN_FRAC", "0")
    eng = _Engine()
    items = _items([1] * 30)
    _, primed, stats = _run(items, eng, 30)
    assert len(primed) == 30 and stats["host_pairs"] == 0


def test_fixed_batch_through_a_server(monkeypatch):
    """LARIAT_PRIME_BATCH = 8: a batch that would overshoot 8 pairs goes
    as it stands when it holds more than 4 pairs, else to the host; one
    group past 8 pairs and an end-of-input remainder of at most 4 go to the
    host."""
    monkeypatch.setenv("LARIAT_PRIME_BATCH", "8")
    eng = _Engine(path="/nowhere.sock")
    sizes = [2, 7, 3, 3, 3, 2, 9, 1, 1, 5, 4, 4, 2, 1]
    items = _items(sizes)
    _, primed, stats = _run(items, eng, 8)
    assert eng.batches == [7, 6, 5, 7, 8]
    assert primed == [1, 2, 3, 4, 5, 7, 8, 9, 10, 11]
    assert stats == {"primed_pairs": 33, "host_pairs": 14}


def test_no_fixed_batch_without_a_server(monkeypatch):
    monkeypatch.setenv("LARIAT_PRIME_BATCH", "8")
    eng = _Engine()
    _run(_items([300] * 7), eng, 8)
    assert eng.batches == [1200, 900]    # 1024 until the rate is known


class _LateThreads(cli.ThreadPoolExecutor):
    """A pool whose threads are made 0.3 s after a submit asks for one, as
    on a host too loaded to schedule a new thread at once."""

    def _adjust_thread_count(self):
        threading.Timer(0.3, super()._adjust_thread_count).start()


def test_eof_never_cancels_a_batch_given_a_free_thread(monkeypatch):
    """The end-of-input remainder goes to a free thread that starts late:
    it is primed, not cancelled and host-routed, however long the thread
    takes to pick it up."""
    monkeypatch.setattr(cli, "ThreadPoolExecutor", _LateThreads)
    monkeypatch.setenv("LARIAT_PRIME_TAIL_GRACE", "60")
    eng = _Engine()
    _, primed, stats = _run(_items([300] * 7), eng, 8)
    assert eng.batches == [1200, 900]
    assert len(primed) == 7 and stats["host_pairs"] == 0


class _OneWorker(cli.ThreadPoolExecutor):
    def __init__(self, max_workers=None, **kw):
        super().__init__(max_workers=1, **kw)


def test_eof_cancels_queued_then_aborts_after_grace(monkeypatch):
    """Two slots but one worker: the second batch queues behind the held
    first. At the end of input the queued batch is cancelled and
    host-routed; the held one outlasts the grace, the engine is told to
    abort, and its batch goes to the host, its result discarded."""
    _target(monkeypatch, 2)
    monkeypatch.setattr(cli, "ThreadPoolExecutor", _OneWorker)
    monkeypatch.setenv("LARIAT_PRIME_TAIL_GRACE", "0.2")
    eng = _Engine(hold=True)
    items = _items([1] * 7)
    seqs, primed, stats = _run(items, eng, 2)
    assert eng.abort_prime and eng.batches == [2]
    assert primed == [] and stats["host_pairs"] == 7
    # the third batch host-routed at once (both slots busy), then the
    # remainder, the cancelled batch, the abandoned one
    assert seqs == [4, 5, 6, 2, 3, 0, 1]


# (pairs/s measured, batch pairs, elapsed s, grace s): the reference's
# min(max(2, auto), max(2, 0.15 elapsed), 30), auto = 1.5 batch / rate or
# 5 s before a batch lands (lariat_tpu/cli.py primed_iter)
GRACES = [(None, 1024, 0.1, 2.0), (None, 1024, 20.0, 3.0),
          (None, 1024, 100.0, 5.0), (1000.0, 2000, 100.0, 3.0),
          (1000.0, 800, 100.0, 2.0), (100.0, 16384, 1000.0, 30.0),
          (100.0, 16384, 60.0, 9.0)]


@pytest.mark.parametrize("rate,batch,elapsed,want", GRACES)
def test_tail_grace_formula(monkeypatch, rate, batch, elapsed, want):
    monkeypatch.delenv("LARIAT_PRIME_TAIL_GRACE", raising=False)
    assert cli._tail_grace(rate, batch, elapsed) == pytest.approx(want)
    monkeypatch.setenv("LARIAT_PRIME_TAIL_GRACE", "0.7")
    assert cli._tail_grace(rate, batch, elapsed) == 0.7


def test_default_tail_grace_aborts_after_2s(monkeypatch):
    """LARIAT_PRIME_TAIL_GRACE unset and a pass that never lands: with no
    rate measured the grace is min(5.0, max(2.0, 0.15 x elapsed), 30) =
    2.0 s in a run this short; then the engine is told to abort and the
    batch is host-routed, every item once. Tolerance: the wait ends 2.0 s
    after the end of the input, less 0.05 s for the timer, plus 0.5 s for
    the abort's poll and the threads."""
    _target(monkeypatch, 2)
    monkeypatch.delenv("LARIAT_PRIME_TAIL_GRACE", raising=False)
    eng = _Engine(hold=True)
    items = _items([1] * 4)
    eof = {}

    def feed():
        yield from items
        eof["t"] = time.monotonic()

    _, primed, stats = _run(items, eng, 1, feed())
    waited = time.monotonic() - eof["t"]
    assert eng.abort_prime and eng.batches == [2] and primed == []
    assert stats == {"primed_pairs": 0, "host_pairs": 4}
    assert 1.95 <= waited < 2.5, waited


def test_eof_remainder_primed_when_a_slot_is_free(monkeypatch):
    _target(monkeypatch, 100)
    monkeypatch.setenv("LARIAT_PRIME_TAIL_GRACE", "60")
    eng = _Engine()
    _, primed, stats = _run(_items([1] * 5), eng, 2)
    assert eng.batches == [5] and stats["host_pairs"] == 0


def test_raising_engine_fails_the_cli(tmp_path, monkeypatch):
    """An engine error (not an abort) ends the CLI run with an error and
    is never host-routed."""
    fasta, fq = _inputs(tmp_path)

    class Failing:
        abort_prime = False
        wave_stats = {"wall": 0.0, "n": 0}

        def prime_regions(self, recs, score_delta):
            raise ValueError("wave failed")

    monkeypatch.setattr(cli, "_device_engine", lambda genome, fm: Failing())
    with pytest.raises(RuntimeError, match="device priming failed") as e:
        cli.main(["-reads", str(fq), "-genome", str(fasta), "-output",
                  str(tmp_path / "o"), "-threads", "2", "-use_device", "on",
                  "-first_chunk"])
    assert isinstance(e.value.__cause__, ValueError)
