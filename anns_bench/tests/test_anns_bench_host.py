"""The host's per-thread readings over a window, from ``/proc``."""
from __future__ import annotations

import threading
import time


from anns_bench import host


def test_thread_readings_name_python_threads():
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(1000))

    before = host.reading()
    t = threading.Thread(target=spin, name="spinner")
    t.start()
    deadline = time.monotonic() + 30
    try:
        while host.threads().get(t.native_id, ("", 0.0))[1] < 0.05 \
                and time.monotonic() < deadline:
            pass
        use = host.window_use(before)
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()
    rows = {r[0]: r for r in use["threads"]}
    assert rows["spinner"][1] == t.native_id and rows["spinner"][2] >= 0.05
    assert rows["MainThread"][1] == threading.get_native_id()
    assert all(len(r) == 6 and r[3] >= 0 and r[4] >= 0 and r[5] >= 0
               for r in rows.values())
    assert use["caller_cpu_s"] > 0 and use["process_cpu_s"] >= 0.05
    assert use["cpus_allowed"]


def test_thread_use_is_the_difference_of_two_readings():
    before = {1: ("a", 1.0, 10, 2, 0), 2: ("b", 3.0, 0, 0, 1)}
    after = {1: ("a", 1.5, 12, 2, 3), 2: ("b", 3.0, 0, 0, 1),
             7: ("c", 2.0, 1, 1, 5)}
    assert host.thread_use(before, after) == [["c", 7, 2.0, 1, 1, 5],
                                              ["a", 1, 0.5, 2, 0, 3]]
    assert host.thread_use(before, after, top=1) == [["c", 7, 2.0, 1, 1, 5]]


BUS = "0000:3b:00.0"


def _sysfs(root, node: str, siblings: dict) -> str:
    """A fake sysfs tree: the card's ``local_cpulist`` and each CPU's
    ``thread_siblings_list``."""
    dev = root / "bus" / "pci" / "devices" / BUS
    dev.mkdir(parents=True)
    (dev / "local_cpulist").write_text(node + "\n")
    for cpu, sib in siblings.items():
        top = root / "devices" / "system" / "cpu" / f"cpu{cpu}" / "topology"
        top.mkdir(parents=True)
        (top / "thread_siblings_list").write_text(sib + "\n")
    return str(root)


# two sockets of 4 cores, two threads a core: CPU n and n + 16 are siblings
SIBLINGS = {c: f"{c % 16},{c % 16 + 16}" for c in [*range(16), *range(16, 32)]}


def test_cpulist_parses_ranges_and_singles():
    assert host.cpulist("0-3,8,10-11\n") == {0, 1, 2, 3, 8, 10, 11}
    assert host.cpulist("5") == {5}
    assert host.cpulist("") == set()


def test_placement_keeps_the_cards_node_one_cpu_a_core(tmp_path):
    sysfs = _sysfs(tmp_path, "8-15,24-31", SIBLINGS)
    cpus, how = host.placement(BUS, range(32), sysfs)
    assert cpus == list(range(8, 16)) and how.startswith("the card's node")
    # only the second thread of cores 8 and 9 allowed: it stands for its
    # core; 26 shares core 10 with 10, which comes first
    cpus, _ = host.placement(BUS, [*range(10, 12), 24, 25, 26], sysfs)
    assert cpus == [10, 11, 24, 25]


def test_placement_falls_back_to_the_allowed_set(tmp_path):
    sysfs = _sysfs(tmp_path, "8-15,24-31", SIBLINGS)
    allowed = {0, 1, 2, 3}
    cpus, how = host.placement(BUS, allowed, sysfs)       # empty intersection
    assert cpus == [0, 1, 2, 3] and "none of the card's node" in how
    cpus, how = host.placement("0000:5e:00.0", allowed, sysfs)  # no device
    assert cpus == [0, 1, 2, 3] and "FileNotFoundError" in how
    cpus, how = host.placement(None, allowed, sysfs)      # no address
    assert cpus == [0, 1, 2, 3] and "no PCI address" in how


def test_placement_falls_back_where_topology_cannot_be_read(tmp_path):
    sysfs = _sysfs(tmp_path, "0-3", {0: "0", 1: "1"})      # no cpu2, cpu3
    cpus, how = host.placement(BUS, range(4), sysfs)
    assert cpus == [0, 1, 2, 3] and how.startswith("allowed")
    (tmp_path / "bus/pci/devices" / BUS / "local_cpulist").write_text("x-y")
    cpus, how = host.placement(BUS, range(2), sysfs)
    assert cpus == [0, 1] and "ValueError" in how


def test_bus_id_is_read_as_sysfs_names_it(monkeypatch):
    class Out:
        stdout = "00000000:3B:00.0\n"

    monkeypatch.setattr(host.subprocess, "run", lambda *a, **k: Out)
    assert host.bus_id() == BUS
    Out.stdout = "[N/A]\n"
    assert host.bus_id() is None
    Out.stdout = ""
    assert host.bus_id() is None

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(host.subprocess, "run", missing)
    assert host.bus_id() is None
