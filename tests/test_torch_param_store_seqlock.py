"""The parameter store's sequence lock (agents/param_store.py
``ParamStore``): a reader takes no lock, so a reader stopped or killed in
the middle of a copy (an actor that the hang watchdog stops and kills)
cannot block the learner's next publish; and every snapshot a reader
gets across processes is one publish's whole vector."""

import multiprocessing as mp
import os
import signal
import threading
import time

import numpy as np

from pytorch_distributed_tpu_torch.agents.param_store import ParamStore

N = 1 << 22      # 16 MiB: a reader spends most of its time in a copy
PUBLISHES = 200  # the coherence test's publishes


def _read_forever(store, started) -> None:
    started.set()
    while True:
        store.fetch(0)


def _publish_in_time(store, value: float, seconds: float = 10.0) -> bool:
    done = threading.Event()

    def run():
        store.publish(np.full(store.num_params, value, np.float32))
        done.set()

    threading.Thread(target=run, daemon=True).start()
    return done.wait(seconds)


def test_publish_outlives_a_reader_stopped_and_killed_mid_copy():
    ctx = mp.get_context("spawn")
    store = ParamStore(N)
    store.publish(np.zeros(N, np.float32))
    started = ctx.Event()
    reader = ctx.Process(target=_read_forever, args=(store, started),
                         daemon=True)
    reader.start()
    try:
        assert started.wait(120)
        for i in range(5):  # stopped at five points of its loop
            time.sleep(0.03)
            os.kill(reader.pid, signal.SIGSTOP)
            assert _publish_in_time(store, i + 1.0)
            os.kill(reader.pid, signal.SIGCONT)
        time.sleep(0.03)
        os.kill(reader.pid, signal.SIGSTOP)
        reader.kill()
        reader.join(10)
        assert _publish_in_time(store, 9.0)
        flat, version = store.fetch(0)
        assert version == 7 and (flat == 9.0).all()
    finally:
        if reader.is_alive():
            reader.kill()
            reader.join(10)


def _publish_versions(store, ack) -> None:
    for v in range(1, PUBLISHES + 1):
        store.publish(np.full(store.num_params, v, np.float32))
        # back to back, a writer can keep every copy of the reader torn
        # (it retries) until its last publish: wait, at most 5 ms, for the
        # reader to take this version, then write the next one while it
        # polls, as a learner's publications go on under an actor's reads
        until = time.monotonic() + 0.005
        while ack.value < v and time.monotonic() < until:
            time.sleep(0)


def test_every_fetch_is_one_whole_publish():
    ctx = mp.get_context("spawn")
    store = ParamStore(1 << 18)
    ack = ctx.Value("l", 0, lock=False)
    writer = ctx.Process(target=_publish_versions, args=(store, ack))
    writer.start()
    seen, last = set(), 0
    try:
        deadline = time.monotonic() + 120
        while last < PUBLISHES and time.monotonic() < deadline:
            got = store.fetch(last)
            if got is None:
                continue
            flat, version = got
            assert version > last
            assert flat.min() == flat.max() == version
            seen.add(version)
            last = ack.value = version
    finally:
        writer.join(60)
    assert writer.exitcode == 0 and last == PUBLISHES and len(seen) > 1
