"""The serving launcher's sampling and default against the reference
launcher (the reduced configs): sampled at ``--temperature 0.8`` (``key,
sub = split(key)`` from ``PRNGKey(1)`` each step, ``categorical(sub,
logits / T)``) for xlstm-125m (the default arch), granite-moe-1b-a400m
and qwen3-1.7b on the launcher's default flags, the same sample token
ids; and the default arch the reference launcher's."""
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("arch", ["xlstm-125m", "granite-moe-1b-a400m",
                                  "qwen3-1.7b"])
def test_serve_sampled_prints_reference_tokens(arch, monkeypatch, capsys):
    flags = ["--arch", arch, "--temperature", "0.8"]
    monkeypatch.setattr("sys.argv", ["serve", *flags])
    jserve.main()
    j_out = capsys.readouterr().out
    tserve.main([*flags, "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert _ids(t_out) == _ids(j_out)


class _Chosen(Exception):
    pass


def test_serve_default_arch_is_the_references(monkeypatch):
    """Both launchers, given no ``--arch``, pick xlstm-125m (the
    reference's is read where its launcher asks for the config)."""
    def chosen(arch):
        raise _Chosen(arch)

    monkeypatch.setattr(jserve, "get_config", chosen)
    monkeypatch.setattr("sys.argv", ["serve"])
    with pytest.raises(_Chosen) as e:
        jserve.main()
    assert e.value.args[0] == tserve.parse_args([]).arch == "xlstm-125m"
