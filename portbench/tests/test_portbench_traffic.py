"""The traffic generator: deterministic per seed, true to its mix file,
and the same work for every seed."""
import threading

import numpy as np

from portbench import spec, traffic


def _mix(name):
    return spec.load_json(spec.HERE / "mixes" / f"{name}.json")


def _take(seq, n):
    return [seq.next() for _ in range(n)]


def test_sequence_is_deterministic_and_follows_its_file():
    mix = _mix("warm-score")
    a = _take(traffic.Sequence(mix, 2**31 + 7, 50304), 95)
    b = _take(traffic.Sequence(mix, 2**31 + 7, 50304), 95)
    assert [k for k, _ in a] == list(range(95))
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert {t.shape[0] for _, t in a} == {mix["batch"]}
    lengths = [t.shape[1] for _, t in a]
    block = mix["block"]
    for j in range(0, 90, block):                # every whole block in exact proportion
        part = lengths[j:j + block]
        for L, w in zip(mix["lengths"], mix["weights"]):
            assert part.count(L) == round(w * block)
    assert all(t.min() >= 0 and t.max() < 50304 for _, t in a)


def test_seeds_share_the_work_in_another_order():
    mix = _mix("warm-score")
    a = [t.shape[1] for _, t in _take(traffic.Sequence(mix, 1, 32000), 100)]
    b = [t.shape[1] for _, t in _take(traffic.Sequence(mix, 2**33 + 1, 32000), 100)]
    assert sorted(a) == sorted(b) and a != b


def test_callers_on_threads_take_each_invocation_once():
    mix = _mix("warm-score")
    seq = traffic.Sequence(mix, 5, 100)
    got, lock = {}, threading.Lock()

    def caller():
        for _ in range(25):
            k, t = seq.next()
            with lock:
                got[k] = t
    threads = [threading.Thread(target=caller) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    alone = dict(_take(traffic.Sequence(mix, 5, 100), 100))
    assert sorted(got) == list(range(100))
    assert all(np.array_equal(got[k], alone[k]) for k in alone)


def test_sample_holds_the_first_longest_and_follows_the_seed():
    mix = _mix("warm-score")
    keep = traffic.sample(mix, 2**31 + 9)
    assert keep == traffic.sample(mix, 2**31 + 9) and len(keep) == mix["sample"]
    assert max(keep) < mix["sample_span"]
    seq = traffic.Sequence(mix, 2**31 + 9, 50304)
    lengths = [seq.length(k) for k in range(mix["sample_span"])]
    assert lengths.index(max(mix["lengths"])) in keep
