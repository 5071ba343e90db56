"""The port's observability surface and flag guard, held against the
reference.

- ``/metrics`` scraped after two daemon rounds names the same metric
  families in both packages; the build-identity gauge's labels differ
  only where the port names its stack (``torch`` and ``cuda`` in place
  of ``jax``);
- ``trace report`` (and the Chrome export) of a trace log the port's
  daemon wrote equals the reference's report of the same log;
- every flag of a module the port has not ported stops the daemon with
  an error naming it, and so do the bridge options behind them; the
  daemon's default device is the card;
- the kernel loader's compile-latency seam feeds the metrics histogram.
"""

from __future__ import annotations

import json
import re
import socket
import urllib.request

import pytest
import torch

import poseidon_tpu.apiclient as ref_api
import poseidon_tpu.cli as ref_cli
import poseidon_tpu.obs.report as ref_report
import poseidon_tpu.obs.spans as ref_spans
import poseidon_tpu.trace as ref_trace
import poseidon_tpu_torch.apiclient as port_api
import poseidon_tpu_torch.cli as port_cli
import poseidon_tpu_torch.obs.report as port_report
import poseidon_tpu_torch.obs.spans as port_spans
import poseidon_tpu_torch.trace as port_trace

from tests.test_torch_graph import build_reference_oracle


@pytest.fixture(autouse=True, scope="module")
def _reference_oracle_built():
    """The reference's side of these tests can solve on its C++ oracle,
    which it builds in place on first use: have the binary whole first
    (``tests/test_torch_graph.py``'s ``build_reference_oracle``)."""
    build_reference_oracle()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _populate(server):
    for i in range(4):
        server.add_node(f"n{i}", cpu="8", memory="16Gi", pods=6,
                        rack=f"rack{i % 2}")
    for j in range(20):
        server.add_pod(f"pod-{j:02d}", cpu="250m", memory="256Mi",
                       job=f"job{j // 5}",
                       data_prefs={f"n{j % 4}": 40} if j % 2 else None)


def _scrape_after_two_rounds(api, cli, extra):
    port = _free_port()
    scraped = {}

    def hook(rounds, _result):
        if rounds == 2:
            url = f"http://127.0.0.1:{port}/metrics"
            with urllib.request.urlopen(url, timeout=10) as resp:
                scraped["text"] = resp.read().decode()

    with api.FakeApiServer() as server:
        _populate(server)
        rc = cli.run_loop(cli.parse_args([
            f"--k8s_apiserver_port={server.port}",
            "--k8s_apiserver_host=127.0.0.1", "--polling_frequency=1000",
            "--max_rounds=2", f"--metrics_port={port}",
            "--metrics_host=127.0.0.1", *extra,
        ]), round_hook=hook)
    assert rc == 0
    return scraped["text"]


def _families(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _build_info_labels(text: str) -> set[str]:
    line = next(ln for ln in text.splitlines()
                if ln.startswith("poseidon_build_info{"))
    return set(re.findall(r'(\w+)="', line))


def test_metrics_families_equal_reference():
    ref = _scrape_after_two_rounds(ref_api, ref_cli, [])
    port = _scrape_after_two_rounds(port_api, port_cli, ["--device=cpu"])
    assert _families(port) == _families(ref)
    assert len(_families(port)) > 20
    ref_labels = _build_info_labels(ref)
    port_labels = _build_info_labels(port)
    assert port_labels == (ref_labels - {"jax"}) | {"torch", "cuda"}
    # the rounds really were recorded
    assert re.search(r"^poseidon_rounds_total\S* [1-9]", port, re.M)


def _write_trace(path):
    with port_api.FakeApiServer() as server:
        _populate(server)
        server.add_pod("late", cpu="250m", memory="256Mi")
        rc = port_cli.run_loop(port_cli.parse_args([
            f"--k8s_apiserver_port={server.port}",
            "--k8s_apiserver_host=127.0.0.1", "--polling_frequency=1000",
            "--max_rounds=3", f"--trace_log={path}",
            "--trace_profile=true", "--watch=true", "--device=cpu",
        ]))
    assert rc == 0


def test_trace_report_of_port_log_equals_reference(tmp_path, capsys):
    path = str(tmp_path / "trace.jsonl")
    _write_trace(path)
    port_data = port_report.analyze_trace(path)
    ref_data = ref_report.analyze_trace(path)
    assert port_data == ref_data
    assert port_report.render_report(port_data) == ref_report.render_report(
        ref_data)
    # the command lines print the same report
    capsys.readouterr()
    assert port_trace.main(["report", path, "--json"]) == 0
    port_out = capsys.readouterr().out
    assert ref_trace.main(["report", path, "--json"]) == 0
    ref_out = capsys.readouterr().out
    assert json.loads(port_out) == json.loads(ref_out)
    # and the Chrome export of the SPAN events
    a = port_spans.write_chrome_trace(port_trace.read_trace(path),
                                      str(tmp_path / "port.json"))
    b = ref_spans.write_chrome_trace(ref_trace.read_trace(path),
                                     str(tmp_path / "ref.json"))
    with open(a) as fa, open(b) as fb:
        port_chrome, ref_chrome = json.load(fa), json.load(fb)
    assert port_chrome == ref_chrome
    assert port_chrome


# the scale lane's flags, refused until their item was ported; their
# cases below now check that they parse and reach the bridge
SCALE_FLAGS = [
    ("mesh_width", "1"),
    ("aggregate_classes", "true"), ("topk_prefs", "2"),
]
# the flags ROADMAP Queue 1 item 7 ported (crash safety, the flight
# recorder, explainer, audit and SLOs), each at a non-default value
UNPORTED = [
    ("flight_recorder", "true"), ("flight_dir", "fr"),
    ("flight_max_dumps", "2"), ("explain", "pod-00"),
    ("audit_every", "2"), ("slo", "ready"), ("slo_short_window", "3"),
    ("slo_long_window", "30"), ("slo_burn_threshold", "2.0"),
    ("checkpoint_dir", "ckpt"), ("checkpoint_every", "5"),
    ("restore", "false"), ("standby", "true"), ("standby_lease_s", "5"),
]


def test_unported_flags_are_the_listed_ones():
    """Every module is ported: the table of unported flags is empty,
    and each flag it used to list is an option of the parser."""
    assert port_cli.UNPORTED_FLAGS == {}
    options = vars(port_cli.parse_args([]))
    assert all(flag in options for flag, _ in UNPORTED)


def test_unported_flags_take_the_reference_defaults():
    """Each formerly unported flag defaults as the reference's does,
    and a flagfile that spells every one of them at that default
    loads."""
    ref = vars(ref_cli.build_parser().parse_args([]))
    port = vars(port_cli.parse_args([]))
    for name, _ in UNPORTED:
        assert port[name] == ref[name], name
    spelled = [f"--{name}={ref[name]}" for name, _ in UNPORTED]
    args = port_cli.parse_args(spelled)
    assert port_cli.unported_flags(args) == []
    # every option of the reference's parser is one the port knows
    assert set(ref) <= set(port)


@pytest.mark.parametrize("flag,value", SCALE_FLAGS + UNPORTED)
def test_unported_flag_exits_with_an_error(flag, value, capsys):
    """Every flag is ported now: it parses at the value, is absent
    from the unported table, and the parsed value is the reference's
    parse of the same spelling. (The name is kept from when these flags
    were refused; it checks that none is.)"""
    args = port_cli.parse_args(["--device=cpu", f"--{flag}={value}"])
    assert flag not in port_cli.UNPORTED_FLAGS
    assert port_cli.unported_flags(args) == []
    ref = ref_cli.build_parser().parse_args([f"--{flag}={value}"])
    assert getattr(args, flag) == getattr(ref, flag)
    assert getattr(args, flag) != getattr(port_cli.parse_args([]), flag)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("option", [
    {"flightrec": "recorder"}, {"auditor": "auditor"},
    {"mesh_width": 1}, {"aggregate_classes": True}, {"topk_prefs": 2},
])
def test_unported_bridge_options_raise(option, tmp_path):
    """No bridge option raises any more: the flight recorder and the
    shadow auditor ride the bridge, the scale lane's options reach its
    solver. (The name is kept from when these options raised; it checks
    that none does.)"""
    from poseidon_tpu_torch.bridge import SchedulerBridge
    from poseidon_tpu_torch.obs import FlightRecorder, ShadowAuditor

    (name, value), = option.items()
    if name in ("flightrec", "auditor"):
        value = (FlightRecorder(str(tmp_path)) if name == "flightrec"
                 else ShadowAuditor(background=False))
        bridge = SchedulerBridge(device="cpu", **{name: value})
        assert getattr(bridge, name) is value
        if name == "flightrec":
            assert value.device == bridge.solver.device
        return
    # the scale lane's options are ported: the bridge's solver takes them
    bridge = SchedulerBridge(device="cpu", **option)
    assert getattr(bridge.solver, name) == value
    assert bridge.round_flags[name] == value


def test_daemon_defaults_to_the_card(monkeypatch):
    from poseidon_tpu_torch.bridge import SchedulerBridge

    assert port_cli.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SchedulerBridge()
    with port_api.FakeApiServer() as server:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            port_cli.run_loop(port_cli.parse_args([
                f"--k8s_apiserver_port={server.port}",
                "--k8s_apiserver_host=127.0.0.1", "--max_rounds=1",
            ]))


def test_compile_sink_feeds_the_histogram_and_build_info():
    from poseidon_tpu_torch.guards import (
        report_compile,
        set_compile_duration_sink,
    )
    from poseidon_tpu_torch.obs import (
        MetricsRegistry,
        SchedulerMetrics,
        build_info,
    )

    metrics = SchedulerMetrics(MetricsRegistry())
    assert set_compile_duration_sink(metrics.record_compile)
    try:
        report_compile(1234.5)
    finally:
        set_compile_duration_sink(None)
    report_compile(99.0)  # no sink: dropped
    text = metrics.registry.render()
    assert re.search(r"^poseidon_xla_compile_ms_count 1(\.0)?$", text, re.M)
    info = build_info(device="cpu")
    assert info["torch"] == torch.__version__ and info["backend"] == "cpu"
    assert metrics.record_live_hbm(torch.device("cpu")) is None
