"""The port's ``launch/compress.py`` beside the JAX package's, in-process on
the CPU, on E3SM ``--quick --epochs-scale 0.05`` (36 hyper-blocks, one HBAE
and one BAE step).

Both launchers exit 0 and print "verify OK"; the port exits 2 on a
guarantee violation, 3 when the disk re-read raises ``ArchiveError`` or the
streaming write fails, streams with ``--stream`` (and its fault-tolerance
flags), and refuses a ``--mesh`` of more shards than the host's one CPU (the
JAX launcher's device-count ``ConfigError`` on one device) and the
fault-tolerance flags without ``--stream`` at parse time, before it makes a
dataset or trains.
"""
from __future__ import annotations

import pytest

from repro.launch import compress as j_cli
from repro.runtime import archive_io as j_io
from repro_torch.core.errors import ArchiveError
from repro_torch.core.pipeline import HierarchicalCompressor
from repro_torch.data import synthetic
from repro_torch.launch import compress as t_cli
from repro_torch.runtime import archive_io

TAU = 0.5
ARGS = ["--dataset", "e3sm", "--quick", "--epochs-scale", "0.05",
        "--tau", str(TAU)]


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_port_and_jax_launchers_verify(tmp_path, capsys):
    rc, out, _ = _run(j_cli.main, ARGS + ["--out", str(tmp_path / "j.rba"),
                                          "--verify"], capsys)
    assert rc == 0 and "verify OK" in out
    rc, out, err = _run(t_cli.main, ARGS + [
        "--out", str(tmp_path / "t.rba"), "--verify", "--device", "cpu",
        "--save", str(tmp_path / "t.npz")], capsys)
    assert rc == 0, err
    for line in ("e3sm: 36 hyper-blocks of (k=5, D=1536)", "step 0: mse",
                 "compression ratio:", "NRMSE:", "container written to",
                 "verify OK: disk round-trip bit-exact", "model saved to"):
        assert line in out
    loaded = HierarchicalCompressor.load(str(tmp_path / "t.npz"),
                                         device="cpu")
    recon = loaded.decompress(archive_io.read_archive(str(tmp_path / "t.rba")))
    assert recon.shape == (36, 5, 1536)


def test_port_launcher_exits_2_on_a_guarantee_violation(monkeypatch, capsys):
    decompress = HierarchicalCompressor.decompress

    def off_by_tau(self, archive, strict=True, mesh=None):
        recon = decompress(self, archive, strict, mesh)
        recon[0, 0, 0] += 2 * TAU
        return recon

    monkeypatch.setattr(HierarchicalCompressor, "decompress", off_by_tau)
    rc, _, err = _run(t_cli.main, ARGS + ["--device", "cpu"], capsys)
    assert rc == 2 and "tau guarantee violated on 1/" in err


def test_port_launcher_exits_3_when_the_reread_fails(monkeypatch, tmp_path,
                                                       capsys):
    def unreadable(path, strict=True):
        raise ArchiveError(f"{path}: injected")

    monkeypatch.setattr(archive_io, "read_archive", unreadable)
    rc, out, err = _run(t_cli.main, ARGS + [
        "--out", str(tmp_path / "t.rba"), "--verify", "--device", "cpu"],
        capsys)
    assert rc == 3 and "verification re-read failed" in err
    assert "container written to" in out and "verify OK" not in out


@pytest.mark.parametrize("flags", [
    ["--stream"], ["--stream", "--queue-depth", "3"],
    ["--stream", "--retries", "1"], ["--stream", "--stage-deadline", "5"],
    ["--stream", "--chaos", "0"]])
def test_port_launcher_streams(flags, tmp_path, capsys):
    out_path = str(tmp_path / "s.rba")
    rc, out, err = _run(t_cli.main, ARGS + [
        "--out", out_path, "--verify", "--device", "cpu"] + flags, capsys)
    assert rc == 0, err
    for line in ("stream: 1 items -> 1 chunks", "container streamed to",
                 "verify OK: disk round-trip bit-exact"):
        assert line in out
    if "--chaos" in flags:
        assert "fault tolerance:" in out and "chaos injected:" in out
    assert len(j_io.read_archive(out_path).chunks) == 1   # JAX reads it
    assert not (tmp_path / "s.rba.partial").exists()


def test_port_launcher_exits_3_when_the_streaming_write_fails(tmp_path,
                                                              capsys):
    rc, out, err = _run(t_cli.main, ARGS + [
        "--out", str(tmp_path / "missing" / "s.rba"), "--device", "cpu",
        "--stream"], capsys)
    assert rc == 3 and "streaming write failed" in err
    assert "container streamed to" not in out


@pytest.mark.parametrize("flags,message", [
    (["--mesh", "2"], "wants 2 shards but only 1 device(s)"),
    (["--retries", "1"], "require --stream")])
def test_port_launcher_refuses_impossible_mesh_and_stray_flags_at_parse_time(
        flags, message, monkeypatch, capsys):
    def no_data(*args, **kwargs):
        raise AssertionError("the launcher made a dataset")

    monkeypatch.setattr(synthetic, "make_dataset", no_data)
    with pytest.raises(SystemExit) as e:
        t_cli.main(ARGS + ["--device", "cpu"] + flags)
    assert e.value.code == 2
    assert message in capsys.readouterr().err
