"""The port's native loader (``data/native_loader.py``) and prefetch thread
(``data/pipeline.py prefetch``) against the JAX package's, on the CPU.

Oracles and bounds:

- the JAX ``native_loader`` wrapper over ``native/faa_loader.cpp`` compiled
  as its Makefile compiles it (``-O3 -fPIC -std=c++17 -Wall -pthread -shared
  -ljpeg``), into a temporary directory (``make -C native`` would write into
  the repository): ``decode_resize_batch`` with and without boxes, the
  failure count and ``gather_u8`` bitwise equal;
- ``tests/data/jpeg_golden/libjpeg.npz``: what the port's libjpeg build makes
  of the golden JPEGs, bitwise (``data/jpeg_golden.py golden_arrays``;
  the card's nvJPEG build is held to it within a stated tolerance there);
- libjpeg's RGB decode: the nvJPEG build's chroma upsampling and colour
  conversion (``csrc/jpeg_ycc.h``) applied to libjpeg's own decoded planes,
  bitwise (only the inverse DCT is nvJPEG's on the card);
- the JAX ``prefetch``'s behaviour (``tests/test_datasets.py:199-240``):
  order, the worker-side transform, errors re-raised in the consumer, an
  abandoned consumer stopping the worker.
"""

import os
import subprocess
import threading
import time

import numpy as np
import pytest

from fast_autoaugment_tpu.data import native_loader as JNL
from fast_autoaugment_tpu.data import pipeline as JP
from fast_autoaugment_tpu_torch.data import native_loader as NL
from fast_autoaugment_tpu_torch.data import pipeline as PL
from fast_autoaugment_tpu_torch.data.jpeg_golden import (
    GOLDEN_DIR,
    departure,
    golden_arrays,
    golden_paths,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_jpegs(root, sizes, seed: int = 0, quality: int = 90) -> list[str]:
    """Random-noise JPEGs of the given ``(width, height)`` sizes (PIL, in
    the tests only)."""
    import PIL.Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (w, h) in enumerate(sizes):
        p = os.path.join(root, f"img{i}.jpg")
        PIL.Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            p, quality=quality)
        paths.append(p)
    return paths


def jax_native_library(tmp_dir) -> str:
    """``native/faa_loader.cpp`` built with the JAX Makefile's flags into
    `tmp_dir`; the JAX wrapper is then pointed at it."""
    out = os.path.join(str(tmp_dir), "libfaa_loader_jax.so")
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread",
                    os.path.join(REPO, "native", "faa_loader.cpp"), "-o", out, "-shared",
                    "-ljpeg", "-pthread"], check=True, capture_output=True)
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The port's libjpeg build (in a temporary build directory) and the JAX
    wrapper over the Makefile's build."""
    if NL.backend() != "libjpeg":
        pytest.fail("this host has no <jpeglib.h>: the CPU tests need the libjpeg build")
    d = tmp_path_factory.mktemp("native")
    port = NL.load(NL.build("libjpeg", d / "port"))
    jax_so = jax_native_library(d)
    saved = JNL._SO_PATH, JNL._lib
    JNL._SO_PATH, JNL._lib = jax_so, None
    try:
        assert JNL.available()
        yield {"port": port, "dir": d}
    finally:
        JNL._SO_PATH, JNL._lib = saved


def test_port_build_is_keyed_and_atomic(tmp_path):
    first = NL.build("libjpeg", tmp_path)
    assert first.parent == tmp_path and first.name.startswith("faa_loader_libjpeg_")
    mtime = first.stat().st_mtime_ns
    assert NL.build("libjpeg", tmp_path) == first and first.stat().st_mtime_ns == mtime
    assert [p.name for p in tmp_path.iterdir()] == [first.name]  # no temporary left
    # nothing is built into native/
    assert sorted(os.listdir(os.path.join(REPO, "native"))) in (
        ["Makefile", "faa_loader.cpp"], ["Makefile", "faa_loader.cpp", "libfaa_loader.so"])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(NL.SOURCES, "libjpeg", bad)
    with pytest.raises(RuntimeError, match="build failed") as e:
        NL.build("libjpeg", tmp_path / "out")
    assert "bad.cpp" in str(e.value) and "error" in str(e.value)


def test_loader_switch_and_backend(monkeypatch):
    monkeypatch.setenv("FAA_NATIVE_LOADER", "0")
    assert not NL.available()
    assert NL.image_size(os.path.join(GOLDEN_DIR, "a420.jpg")) is None
    with pytest.raises(RuntimeError, match="native loader"):
        NL.decode_resize_batch([os.path.join(GOLDEN_DIR, "a420.jpg")], 8)
    with pytest.raises(RuntimeError, match="native JPEG loader was asked for"):
        PL._decoder_name("native")
    assert PL._decoder_name("auto") == "pil"
    monkeypatch.delenv("FAA_NATIVE_LOADER")
    assert NL.available() and NL.loaded_backend() == "libjpeg"
    assert PL._decoder_name("native") == PL._decoder_name("auto") == "libjpeg"
    with pytest.raises(ValueError, match="decoder must be one of"):
        PL._decoder_name("turbo")


@pytest.mark.parametrize("boxed", [False, True])
def test_decode_resize_batch_equals_jax(libs, tmp_path, boxed):
    sizes = [(80, 60), (64, 100), (17, 23), (300, 200), (33, 33)]
    paths = write_jpegs(tmp_path, sizes)
    boxes = None
    if boxed:
        g = np.random.default_rng(1)
        boxes = np.array([[g.uniform(0, w / 3), g.uniform(0, h / 3), g.uniform(w / 2, w),
                           g.uniform(h / 2, h)] for w, h in sizes], np.float32)
    for target in (7, 32, 57):
        got, gf = NL.decode_resize_batch(paths, target, boxes, lib=libs["port"])
        want, wf = JNL.decode_resize_batch(paths, target, boxes)
        assert gf == wf == 0
        assert got.dtype == np.uint8 and got.shape == (len(paths), target, target, 3)
        np.testing.assert_array_equal(got, want)
    assert [NL.image_size(p) for p in paths] == [JNL.image_size(p) for p in paths] == sizes


def test_failures_are_zero_filled_and_counted(libs, tmp_path):
    paths = write_jpegs(tmp_path, [(40, 30), (30, 40)])
    bad = tmp_path / "truncated.jpg"
    bad.write_bytes(open(paths[0], "rb").read()[:100])
    mixed = [paths[0], str(tmp_path / "missing.jpg"), paths[1], str(bad)]
    got, gf = NL.decode_resize_batch(mixed, 16, lib=libs["port"])
    want, wf = JNL.decode_resize_batch(mixed, 16)
    assert gf == wf == 2
    np.testing.assert_array_equal(got, want)
    assert got[1].max() == 0 and got[3].max() == 0 and got[0].max() > 0
    assert NL.image_size(str(tmp_path / "missing.jpg")) is None
    with pytest.raises(ValueError, match="boxes must be"):
        NL.decode_resize_batch(mixed, 16, np.zeros((2, 4), np.float32), lib=libs["port"])


def test_gather_u8_equals_jax(libs):
    g = np.random.default_rng(2)
    src = g.integers(0, 256, (50, 5, 7, 3), dtype=np.uint8)
    idx = g.integers(0, 50, 33)
    np.testing.assert_array_equal(NL.gather_u8(src, idx), JNL.gather_u8(src, idx))
    np.testing.assert_array_equal(NL.gather_u8(src, idx, threads=1), src[idx])
    with pytest.raises(IndexError):
        NL.gather_u8(src, np.array([0, 50]))


def test_libjpeg_build_reproduces_the_golden(libs):
    want = dict(np.load(GOLDEN_DIR / "libjpeg.npz"))
    got = golden_arrays(libs["port"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    d = departure(got, want)
    assert d["full_resolution"]["max_abs"] == d["resized"]["max_abs"] == 0


# the nvJPEG build's colour path on the CPU: libjpeg's raw planes (its own
# inverse DCT) through csrc/jpeg_ycc.h against libjpeg's RGB decode
_YCC_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <jpeglib.h>
#include "jpeg_ycc.h"

static void rgb(const char* path, std::vector<uint8_t>* px, int* w, int* h) {
  FILE* fh = fopen(path, "rb");
  jpeg_decompress_struct c; jpeg_error_mgr e; c.err = jpeg_std_error(&e);
  jpeg_create_decompress(&c); jpeg_stdio_src(&c, fh); jpeg_read_header(&c, TRUE);
  c.out_color_space = JCS_RGB; jpeg_start_decompress(&c);
  *w = c.output_width; *h = c.output_height; px->resize(size_t(*w) * *h * 3);
  while (c.output_scanline < c.output_height) {
    uint8_t* row = px->data() + size_t(c.output_scanline) * *w * 3;
    jpeg_read_scanlines(&c, &row, 1);
  }
  jpeg_finish_decompress(&c); jpeg_destroy_decompress(&c); fclose(fh);
}

static int planes(const char* path, std::vector<std::vector<uint8_t>>* out, int* cw, int* ch,
                  int* hf, int* vf) {
  FILE* fh = fopen(path, "rb");
  jpeg_decompress_struct c; jpeg_error_mgr e; c.err = jpeg_std_error(&e);
  jpeg_create_decompress(&c); jpeg_stdio_src(&c, fh); jpeg_read_header(&c, TRUE);
  c.raw_data_out = TRUE; c.out_color_space = c.jpeg_color_space; jpeg_start_decompress(&c);
  const int n = c.num_components, maxv = c.max_v_samp_factor;
  std::vector<std::vector<uint8_t>> buf(n); std::vector<int> pw(n);
  for (int i = 0; i < n; ++i) {
    pw[i] = c.comp_info[i].width_in_blocks * DCTSIZE;
    buf[i].assign(size_t(pw[i]) * (c.comp_info[i].height_in_blocks + 4) * DCTSIZE, 0);
  }
  int row = 0;
  while (c.output_scanline < c.output_height) {
    JSAMPARRAY arrs[4]; std::vector<std::vector<JSAMPROW>> rows(n);
    for (int i = 0; i < n; ++i) {
      const int v = c.comp_info[i].v_samp_factor, start = row / maxv * v;
      rows[i].resize(v * DCTSIZE);
      for (int r = 0; r < v * DCTSIZE; ++r) rows[i][r] = buf[i].data() + size_t(start + r) * pw[i];
      arrs[i] = rows[i].data();
    }
    row += jpeg_read_raw_data(&c, arrs, maxv * DCTSIZE);
  }
  for (int i = 0; i < n; ++i) {
    const int dw = c.comp_info[i].downsampled_width, dh = c.comp_info[i].downsampled_height;
    out->emplace_back(size_t(dw) * dh);
    for (int r = 0; r < dh; ++r) memcpy(out->back().data() + size_t(r) * dw,
                                        buf[i].data() + size_t(r) * pw[i], dw);
    cw[i] = dw; ch[i] = dh;
  }
  *hf = n > 1 ? c.comp_info[0].h_samp_factor / c.comp_info[1].h_samp_factor : 1;
  *vf = n > 1 ? c.comp_info[0].v_samp_factor / c.comp_info[1].v_samp_factor : 1;
  jpeg_finish_decompress(&c); jpeg_destroy_decompress(&c); fclose(fh);
  return n;
}

int main(int argc, char** argv) {
  int differing = 0;
  for (int a = 1; a < argc; ++a) {
    std::vector<uint8_t> want; int w, h, cw[4], ch[4], hf, vf;
    rgb(argv[a], &want, &w, &h);
    std::vector<std::vector<uint8_t>> p;
    const int n = planes(argv[a], &p, cw, ch, &hf, &vf);
    std::vector<uint8_t> got(want.size());
    if (n == 1) {
      for (size_t i = 0; i < size_t(w) * h; ++i) {
        got[3 * i] = got[3 * i + 1] = got[3 * i + 2] = p[0][i];
      }
    } else if (hf == 1) {
      faa_jpeg::ycc_to_rgb(p[0].data(), p[1].data(), p[2].data(), w, h, cw[1], got.data());
    } else {
      const int uw = 2 * cw[1], uh = vf * ch[1];
      std::vector<uint8_t> ub(size_t(uw) * uh), ur(size_t(uw) * uh);
      auto up = vf == 2 ? faa_jpeg::upsample_h2v2 : faa_jpeg::upsample_h2v1;
      up(p[1].data(), cw[1], ch[1], ub.data());
      up(p[2].data(), cw[1], ch[1], ur.data());
      faa_jpeg::ycc_to_rgb(p[0].data(), ub.data(), ur.data(), w, h, uw, got.data());
    }
    int d = 0;
    for (size_t i = 0; i < got.size(); ++i) d += got[i] != want[i];
    printf("%s %d\n", argv[a], d);
    differing += d;
  }
  return differing != 0;
}
"""


def test_nvjpeg_colour_path_matches_libjpeg(tmp_path):
    """``csrc/jpeg_ycc.h`` (the nvJPEG build's chroma upsampling and YCbCr to
    RGB) on libjpeg's own decoded planes gives libjpeg's RGB decode bitwise:
    4:2:0, 4:2:2, 4:4:4 and greyscale, odd and tiny sizes, many qualities."""
    import PIL.Image

    src = tmp_path / "harness.cpp"
    src.write_text(_YCC_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(["g++", "-O1", "-std=c++17", f"-I{os.path.dirname(NL.SOURCES['nvjpeg'])}",
                    str(src), "-o", str(exe), "-ljpeg"], check=True, capture_output=True)
    g = np.random.default_rng(9)
    paths = golden_paths()
    for i in range(40):
        w, h = int(g.integers(1, 260)), int(g.integers(1, 260))
        small = g.integers(0, 256, (4, 4, 3), dtype=np.uint8)
        arr = np.asarray(PIL.Image.fromarray(small).resize((w, h), PIL.Image.BICUBIC), np.int32)
        img = PIL.Image.fromarray(np.clip(arr + g.integers(-50, 50, arr.shape), 0, 255)
                                  .astype(np.uint8))
        if i % 8 == 7:
            img = img.convert("L")
        p = str(tmp_path / f"r{i}.jpg")
        kw = {} if i % 8 == 7 else {"subsampling": i % 3}
        img.save(p, quality=int(g.integers(40, 99)), **kw)
        paths.append(p)
    proc = subprocess.run([str(exe), *paths], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout
    assert len(proc.stdout.splitlines()) == len(paths)


# ---------------------------------------------------------------- prefetch


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_order_and_worker_transform(monkeypatch, depth):
    monkeypatch.delenv("FAA_PREFETCH_SYNC", raising=False)
    seen = []

    def transform(item):
        seen.append(threading.current_thread().name)
        return item * 10

    items = list(range(20))
    got = list(PL.prefetch(iter(items), depth=depth, transform=transform))
    want = list(JP.prefetch(iter(items), depth=depth, transform=lambda i: i * 10))
    assert got == want == [i * 10 for i in items]
    assert set(seen) == ({"faa-prefetch"} if depth else {threading.current_thread().name})


def test_prefetch_default_depth_and_sync_switch(monkeypatch):
    assert PL.default_prefetch_depth() == JP.default_prefetch_depth()
    monkeypatch.setenv("FAA_PREFETCH_SYNC", "1")
    names = []
    list(PL.prefetch(iter(range(3)), transform=lambda i: names.append(
        threading.current_thread().name)))
    assert names == [threading.current_thread().name] * 3


@pytest.mark.parametrize("where", ["source", "transform"])
def test_prefetch_reraises_worker_errors(monkeypatch, where):
    monkeypatch.delenv("FAA_PREFETCH_SYNC", raising=False)

    def source():
        yield 1
        if where == "source":
            raise ValueError("bad batch")
        yield 2

    def transform(item):
        if where == "transform" and item == 2:
            raise ValueError("bad batch")
        return item

    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for item in PL.prefetch(source(), transform=transform):
            got.append(item)
    assert got == [1]


def test_prefetch_early_abandon_stops_the_worker(monkeypatch):
    monkeypatch.delenv("FAA_PREFETCH_SYNC", raising=False)
    closed = threading.Event()

    def source():
        try:
            for i in range(10_000):
                yield i
        finally:
            closed.set()

    gen = PL.prefetch(source(), depth=2)
    assert next(gen) == 0
    gen.close()
    assert closed.wait(5.0), "the abandoned source was not closed by the worker"
    deadline = time.time() + 5.0
    while time.time() < deadline and any(t.name == "faa-prefetch" and t.is_alive()
                                         for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "faa-prefetch" and t.is_alive() for t in threading.enumerate())
