"""The port's Kaldi I/O (pkr_tpu_torch.io) against pkr_tpu.io on the CPU.

The port carries its own copy of pkr_tpu.io (it imports nothing of
pkr_tpu), so these tests hold the copy to the reference: the bytes its ark
and scp writers produce, with and without CM compression; what its readers
return for plain, ``path:offset`` and pipe rxspecifiers; the quantized
payload read; the wav reader and the data-directory tables; and the port's
own build of the native reader (native/pkr_ark.cpp compiled into
build/pkr_tpu_torch/, never into native/).  Everything is compared exactly.
"""

import os

import numpy as np
import pytest

from pkr_tpu.io import kaldi_ark as jka
from pkr_tpu.io import DataDir as JDataDir
from pkr_tpu.io.wav import read_wav as j_read_wav
from pkr_tpu_torch.io import DataDir, kaldi_ark as ka, native
from pkr_tpu_torch.io.wav import read_wav, write_wav


def make_mats(seed=0, n=5, F=40):
    """Log-mel-like matrices, one of them 6 rows long (≤ 8 rows: the
    automatic CM method picks format 2 for it)."""
    rng = np.random.default_rng(seed)
    lengths = [57, 6, 130, 201, 33][:n]
    return {f"utt{i}": (rng.standard_normal((r, F)) * 3 + 10).astype(np.float32)
            for i, r in enumerate(lengths)}


def write_both(tmp_path, mats, compress):
    """The same matrices through both writers; returns the two (ark, scp)
    path pairs."""
    out = []
    for tag, mod in (("ref", jka), ("port", ka)):
        d = tmp_path / tag
        d.mkdir()
        ark, scp = str(d / "feats.ark"), str(d / "feats.scp")
        with mod.write_ark_scp(ark, scp, compress=compress) as w:
            for k, m in mats.items():
                w.write(k, m)
        out.append((ark, scp))
    return out


@pytest.mark.parametrize("compress", [False, True])
def test_ark_and_scp_bytes_match_pkr_tpu(tmp_path, compress):
    mats = make_mats()
    (ark_r, scp_r), (ark_p, scp_p) = write_both(tmp_path, mats, compress)
    assert open(ark_p, "rb").read() == open(ark_r, "rb").read()
    scp_text = open(scp_p).read().replace(str(tmp_path / "port"), "DIR")
    assert scp_text == open(scp_r).read().replace(str(tmp_path / "ref"), "DIR")
    for m in mats.values():
        blob = ka.compress_matrix(m)
        assert blob == jka.compress_matrix(m)
        assert blob.startswith(b"CM2" if len(m) <= 8 else b"CM ")
        for method in (1, 2, 3):
            assert ka.compress_matrix(m, method) == jka.compress_matrix(m, method)


@pytest.mark.parametrize("compress", [False, True])
def test_rxspecifiers_read_the_same(tmp_path, compress):
    """Plain, path:offset and pipe reads of the port equal pkr_tpu's, and a
    CM format-1 entry's codes decode to read_mat bit for bit."""
    mats = make_mats(seed=1)
    (_, scp_r), (ark_p, scp_p) = write_both(tmp_path, mats, compress)
    ref = dict(jka.read_mat_scp(scp_r))
    got = dict(ka.read_mat_scp(scp_p))
    assert list(got) == list(mats)
    for k in mats:
        np.testing.assert_array_equal(got[k], ref[k])
    piped = dict(ka.read_mat_ark(f"cat {ark_p} |"))
    plain = dict(ka.read_mat_ark(ark_p))
    for line in open(scp_p):
        key, rx = line.split()
        assert ":" in rx
        mat = ka.read_mat(rx)
        for other in (piped[key], plain[key], jka.read_mat(rx)):
            np.testing.assert_array_equal(mat, other)
        assert ka.read_mat_dims(rx) == mat.shape
        codes = ka.read_mat_codes(rx)
        ref_codes = jka.read_mat_codes(rx)
        if not compress or len(mat) <= 8:
            assert codes is None and ref_codes is None
            continue
        np.testing.assert_array_equal(codes[0], ref_codes[0])
        np.testing.assert_array_equal(codes[1], ref_codes[1])
        decoded = ka._chars_to_floats(codes[0].T, codes[1].T).T
        np.testing.assert_array_equal(decoded, mat)


def test_text_vectors_and_int_vectors_match(tmp_path):
    rng = np.random.default_rng(2)
    vecs = {f"s{i}": rng.standard_normal(8).astype(np.float32) for i in range(4)}
    ka.write_text_vec_ark(str(tmp_path / "p.txt"), vecs)
    jka.write_text_vec_ark(str(tmp_path / "r.txt"), vecs)
    assert open(tmp_path / "p.txt").read() == open(tmp_path / "r.txt").read()
    loaded = ka.load_text_vec_ark(str(tmp_path / "r.txt"))
    ref = jka.load_text_vec_ark(str(tmp_path / "r.txt"))
    for k in vecs:
        np.testing.assert_array_equal(loaded[k], ref[k])
    for tag, mod in (("p", ka), ("r", jka)):
        with open(tmp_path / f"{tag}.vec", "wb") as f:
            mod.write_vec_int(f, np.arange(7, dtype=np.int32), key="k1")
            mod.write_vec_flt(f, vecs["s0"], key="k2")
    assert open(tmp_path / "p.vec", "rb").read() == open(tmp_path / "r.vec", "rb").read()


def test_wav_and_datadir_match(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "data"
    root.mkdir()
    wav_lines, utt2spk = [], []
    for i in range(6):
        samples = (rng.standard_normal(1600 + 160 * i) * 3000).astype(np.float32)
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, samples)
        got, rate = read_wav(path)
        ref, ref_rate = j_read_wav(path)
        assert rate == ref_rate == 16000
        np.testing.assert_array_equal(got, ref)
        wav_lines.append(f"u{i} {path}\n")
        utt2spk.append(f"u{i} spk{i % 3}\n")
    piped, _ = read_wav(f"cat {tmp_path}/u2.wav |")
    np.testing.assert_array_equal(piped, j_read_wav(str(tmp_path / "u2.wav"))[0])
    (root / "wav.scp").write_text("".join(wav_lines))
    (root / "utt2spk").write_text("".join(utt2spk))
    port, ref = DataDir.load(str(root)), JDataDir.load(str(root))
    assert port.utts == ref.utts and port.spks == ref.spks
    assert port["utt2spk"] == ref["utt2spk"] and port["wav.scp"] == ref["wav.scp"]
    assert port.make_spk2utt()["spk2utt"] == ref.make_spk2utt()["spk2utt"]
    assert port.validate() == ref.validate()
    (p_dir, n), (r_dir, rn) = port.assign_spk_ids(), ref.assign_spk_ids()
    assert n == rn and p_dir["utt2spkid"] == r_dir["utt2spkid"]
    (p_tr, p_cv), (r_tr, r_cv) = port.train_cv_split(0.34, 5), ref.train_cv_split(0.34, 5)
    assert (p_tr.utts, p_cv.utts) == (r_tr.utts, r_cv.utts)


def test_native_reader_builds_into_build_dir(tmp_path):
    """The port compiles native/pkr_ark.cpp into build/pkr_tpu_torch/ under a
    name that carries the source's hash, writes nothing into native/, and
    decodes the same matrices and crops as the python codec."""
    native_dir = os.path.dirname(native.SOURCE)
    before = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
              for f in os.listdir(native_dir)}
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "pkr_tpu_torch")
    after = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
             for f in os.listdir(native_dir)}
    assert after == before
    mats = make_mats(seed=4)
    for compress in (False, True):
        d = tmp_path / f"c{int(compress)}"
        d.mkdir()
        with ka.write_ark_scp(str(d / "f.ark"), str(d / "f.scp"), compress=compress) as w:
            for k, m in mats.items():
                w.write(k, m)
        for line in open(d / "f.scp"):
            key, rx = line.split()
            full = ka.read_mat(rx)
            p, off = native.split_rxspec(rx)
            np.testing.assert_array_equal(native.read_mat(p, off), full)
            assert native.mat_dims(p, off) == full.shape
            n = 50
            for start in (0, 3, len(full) - 1):
                crop = native.read_crop_t(p, off, start, n, full.shape[1])
                want = full[(start + np.arange(n)) % len(full)].T
                np.testing.assert_array_equal(crop, want)
    m = mats["utt2"]
    assert native.native_compress(m, 1) == jka.compress_matrix(m, 1)


def test_pipe_writer_reports_a_command_that_exits_first():
    """An output pipe whose command exits before the data reach it: the
    write (a large one flushes at once) or the close (a small one flushes
    there) raises IOError with the command's exit code, every time — never a
    bare BrokenPipeError, whichever side wins the race."""
    for i in range(50):
        size = 1 if i % 2 else 1 << 20
        fd = ka.open_or_fd("| exit 3", mode="wb")
        fd._proc.wait()  # the command is gone before anything is written
        with pytest.raises(IOError, match=r"pipe command failed \(rc=3"):
            fd.write(b"x" * size)
            fd.close()
        assert fd.closed
    with pytest.raises(IOError, match=r"pipe command failed \(rc=3\)"):
        fd = ka.open_or_fd("| cat > /dev/null; exit 3", mode="wb")
        fd.write(b"x")
        fd.close()
