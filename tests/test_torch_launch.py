"""The port's launchers build the configs the JAX launchers build.

One rule for ``--reduced`` in both of the port's launchers
(``repro_torch.launch.arch_config``): JAX's ``reduced(cfg)`` exactly on
the CPU, the same with head_dim 64 on the card (no flash kernel is built
at head_dim 32).  Only parsed configs are compared: the JAX launchers'
``LM`` is replaced by a recorder that stops them, and nothing is built
at full width.

The JAX serve launcher's ``--reduced`` cannot be turned off
(``default=True``), so without ``--reduced`` the two serve launchers
differ: JAX serves the reduced config, the port the published one.
"""
import dataclasses

import pytest

from repro_torch.configs import ARCHS
from repro_torch.launch import CARD_HEAD_DIM, arch_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

NAMES = sorted(ARCHS)


class _Built(Exception):
    pass


def _built_config(monkeypatch, module, argv):
    """The config the launcher ``module`` (JAX or the port's serve)
    builds its LM from."""
    seen = {}

    def record(cfg, **_):
        seen["cfg"] = cfg
        raise _Built

    monkeypatch.setattr(module, "LM", record)
    with pytest.raises(_Built):
        module.main(argv)
    return seen["cfg"]


def _same(port, jax_cfg, **expect):
    """Every field of the port's config equals the JAX config's, after
    ``expect``."""
    want = {f.name: getattr(jax_cfg, f.name)
            for f in dataclasses.fields(port)}
    want.update(expect)
    got = dataclasses.asdict(port)
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_train_configs_equal_jax_on_the_cpu(monkeypatch, name):
    pytest.importorskip("jax")
    from repro.launch import train as jtrain
    for argv in (["--arch", name, "--reduced"],
                 ["--arch", name, "--reduced", "--seq", "24"],
                 ["--arch", name]):
        want = _built_config(monkeypatch, jtrain, argv)
        args = ttrain.parse_args(argv + ["--device", "cpu"])
        _same(ttrain.train_config(args), want)
        card = ttrain.train_config(ttrain.parse_args(argv))
        if "--reduced" in argv:
            _same(card, want, head_dim=CARD_HEAD_DIM)
        else:
            _same(card, want)


@pytest.mark.parametrize("name", NAMES)
def test_serve_configs_equal_jax_on_the_cpu(monkeypatch, name):
    pytest.importorskip("jax")
    from repro.launch import serve as jserve
    argv = ["--arch", name, "--reduced"]
    want = _built_config(monkeypatch, jserve, argv)
    _same(_built_config(monkeypatch, tserve, argv + ["--device", "cpu"]),
          want)
    _same(arch_config(name, reduced_cfg=True, device="cuda"), want,
          head_dim=CARD_HEAD_DIM)
    # without --reduced the JAX launcher still reduces (it cannot be
    # turned off); the port serves the published config
    plain = _built_config(monkeypatch, jserve, ["--arch", name])
    _same(arch_config(name, reduced_cfg=True, device="cpu"), plain)
    assert _built_config(monkeypatch, tserve, ["--arch", name, "--device",
                                             "cpu"]) == ARCHS[name]


def test_help_states_the_rule(capsys):
    for mod, argv in ((tserve, ["--help"]), (ttrain, ["--help"])):
        with pytest.raises(SystemExit):
            (mod.main if mod is tserve else ttrain.parse_args)(argv)
        text = " ".join(capsys.readouterr().out.split())
        assert "reduced(cfg) exactly on the CPU" in text
        assert f"head_dim {CARD_HEAD_DIM}" in text
