"""``python -m repro_torch.launch.serve --device cpu --arch A`` for the
zoo's ten architectures against the reference launcher on the same flags
(its defaults: B 8, prompt 32, 64 new tokens; the reduced configs): the
same sample token ids, greedy (sampling and the default arch in
``test_torch_zoo_sample.py``).  starcoder2-3b's case is the decode-window
repair: its reduced window is 64, and 32 + 64 tokens decode past it over
the full cache, as the reference's ``decode_step(..., window=None)``
does."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402


def _ids(out):
    line, = [ln for ln in out.splitlines()
             if ln.startswith("sample token ids[0]:")]
    return line


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(JARCHS))
def test_serve_greedy_prints_reference_tokens(arch, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch])
    jserve.main()
    j_out = capsys.readouterr().out
    res = tserve.main(["--arch", arch, "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert _ids(t_out) == _ids(j_out)
    assert t_out.splitlines()[0].startswith(f"arch={arch} prefill(8x32) ")
    assert res.gen.shape == (8, 64)
    if arch == "starcoder2-3b":
        assert res.model.cfg.sliding_window == 64 < 32 + 64
