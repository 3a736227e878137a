"""``examples/quickstart_torch.py`` (ROADMAP item 20), the port's twin of
``examples/quickstart.py``, run on the CPU: the prototype engine learns, the
registers read the update, the drift RMSE is the paper's, and the exact
counter rule's trajectory is compensated ITP's."""
import importlib.util
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_torch_runs_on_the_cpu(capfd):
    spec = importlib.util.spec_from_file_location("quickstart_torch",
                                                  ROOT / "examples" / "quickstart_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--device", "cpu"]) == 0
    out = capfd.readouterr().out
    assert "prototype engine: 4 pre × 4 post" in out
    spikes = int(re.search(r"after 200 steps: (\d+) postsynaptic spikes", out).group(1))
    assert 0 < spikes <= 800
    assert "ITP w/o compensation: 0.094753" in out
    comp = float(re.search(r"ITP with τ·ln2 comp\.: (\S+)", out).group(1))
    assert comp < 1e-6
    drift = float(re.search(r"max \|Δw\| = (\S+)", out).group(1))
    assert drift < 1e-6
