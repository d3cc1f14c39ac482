"""The port's entry points on the CPU: the launcher's wall-clock path with
the replay check and both outputs, and the end-to-end example with the
cross-request layer (as ``tests/test_examples_smoke.py`` runs the JAX
package's)."""
import json

from repro_torch.examples import serve_rag_e2e
from repro_torch.launch import serve


def test_launcher_wallclock_replay_check_on_cpu(tmp_path, capsys):
    trace, metrics, arrivals = (tmp_path / n for n in ("trace.json", "metrics.json",
                                                       "arrivals.json"))
    m = serve.main(["--device", "cpu", "--wallclock", "--closed-loop", "2", "--n-requests", "4",
                    "--max-new", "6", "--replay-check", "--trace-out", str(trace),
                    "--metrics-out", str(metrics), "--arrivals-out", str(arrivals)])
    out = capsys.readouterr().out
    assert m.finished == 4
    assert "replay-check ok" in out and "on cpu" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    snap = json.loads(metrics.read_text())
    assert snap["prometheus"].strip()
    assert json.loads(arrivals.read_text())["rows"]


def test_launcher_wallclock_open_loop_on_cpu(capsys):
    m = serve.main(["--device", "cpu", "--wallclock", "--n-requests", "3", "--max-new", "4",
                    "--workflow", "hyde", "--replay-check"])
    assert m.finished == 3
    assert "replay-check ok" in capsys.readouterr().out


def test_example_smoke_with_crossreq_on_cpu(capsys):
    serve_rag_e2e.main(["--smoke", "--crossreq", "--n-requests", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "real-execution RAG serving" in out
    assert "crossreq report:" in out
