"""The port's observability smoke (``python -m repro_torch.obs.smoke``) on
the host: a traced ``ForestServeEngine`` pass, its Perfetto trace,
Prometheus text and JSON snapshot, the duplicate-metric guard, a flight
bundle on a forced breach and the profiler's counter tracks."""

import json

from repro_torch.obs import smoke


def test_obs_smoke_passes_on_the_host(tmp_path, capsys):
    assert smoke.main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("chrome trace ok", "prometheus text ok", "duplicate registration raises: ok",
                 "flight recorder ok", "profiler ok"):
        assert line in out
    json.loads((tmp_path / "snapshot.json").read_text())
    assert sorted((tmp_path / "flight").glob("flight-forest-*"))
