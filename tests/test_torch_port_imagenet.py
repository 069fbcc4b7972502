"""Port parity: the ImageNet data path (``data/preprocess.py``,
``data/native.py``, ``data/imagenet.py``, ``data/sources.py``,
``data/registry.py``) and the CLI's dataset forms against the JAX
package.

A miniature ILSVRC tree is built under ``tmp_path`` with PIL, as
``tests/test_data.py``'s ``imagenet_root`` does: a synset mapping, train
and val solution CSVs, and real JPEG files of several sizes (train under
``train/<wnid>/``, val flat).  Every comparison is bit for bit: both
packages run the same numpy, PIL and (for the native path) the same
``native/fd_native.cpp``, each built by its own package (the port's
into ``fluxdistributed_tpu_torch/_build/``).  Remote sources are served
by a ``http.server`` on 127.0.0.1.
"""

import http.server
import importlib
import os
import threading
import zipfile

import numpy as np
import pytest

from fluxdistributed_tpu.data import imagenet as jimagenet
from fluxdistributed_tpu.data import native as jnative
from fluxdistributed_tpu.data import registry as jregistry
from fluxdistributed_tpu.data import sources as jsources
from fluxdistributed_tpu_torch import data
from fluxdistributed_tpu_torch.data import imagenet, native
from fluxdistributed_tpu_torch.data import registry, sources

# the modules (each package's data/__init__ exports a function of the
# same name)
preprocess = importlib.import_module(
    "fluxdistributed_tpu_torch.data.preprocess")
jpre = importlib.import_module("fluxdistributed_tpu.data.preprocess")
cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

WNIDS = ["n01440764", "n01443537", "n01484850"]
SIZES = [(80, 100), (48, 64), (100, 60), (57, 57)]
CROP, RESIZE = 32, 40


@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet")
    with open(root / "LOC_synset_mapping.txt", "w") as f:
        f.write("n01440764 tench, Tinca tinca\n")
        f.write("n01443537 goldfish, Carassius auratus\n")
        f.write("n01484850 great white shark, white shark\n")
    rng = np.random.default_rng(0)
    train, val = ["ImageId,PredictionString"], ["ImageId,PredictionString"]
    cls_loc = root / "ILSVRC" / "Data" / "CLS-LOC"
    (cls_loc / "val").mkdir(parents=True)
    for w, wnid in enumerate(WNIDS):
        d = cls_loc / "train" / wnid
        d.mkdir(parents=True)
        for i, (h, wd) in enumerate(SIZES):
            image_id = f"{wnid}_{i}"
            arr = rng.integers(0, 255, (h, wd, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{image_id}.JPEG")
            train.append(f"{image_id},{wnid} 1 2 3 4")
        for i in range(2):
            image_id = f"ILSVRC2012_val_{w * 2 + i:08d}"
            arr = rng.integers(0, 255, (70, 90, 3), dtype=np.uint8)
            Image.fromarray(arr).save(cls_loc / "val" / f"{image_id}.JPEG")
            val.append(f"{image_id},{wnid} 5 6 7 8")
    (root / "LOC_train_solution.csv").write_text("\n".join(train) + "\n")
    (root / "LOC_val_solution.csv").write_text("\n".join(val) + "\n")
    return str(root)


@pytest.fixture()
def http_root(imagenet_root):
    """Serve the tree over HTTP on 127.0.0.1; yields (base_url,
    request_log)."""
    requests = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=imagenet_root, **kw)

        def log_message(self, *a):
            pass

        def do_GET(self):
            requests.append(self.path)
            super().do_GET()

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", requests
    finally:
        srv.shutdown()
        t.join(timeout=5)
        srv.server_close()


def _tables(mod, root, split="train", classes=None):
    lt = mod.labels(os.path.join(root, "LOC_synset_mapping.txt"))
    return lt, mod.train_solutions(
        os.path.join(root, f"LOC_{split}_solution.csv"), lt, classes=classes,
        split=split)


def _pair(root, split="train", **kw):
    """The port's and the JAX package's ImageNetDataset on the same tree
    and options."""
    out = []
    for mod in (imagenet, jimagenet):
        lt, table = _tables(mod, root, split)
        out.append(mod.ImageNetDataset(root, table, nclasses=len(lt),
                                       crop=CROP, resize=RESIZE,
                                       num_threads=2, **kw))
    return out


def _batches_equal(a, b, n=6, seed=3, indices=None):
    xa, ya = a.batch(np.random.default_rng(seed), n, indices=indices)
    xb, yb = b.batch(np.random.default_rng(seed), n, indices=indices)
    assert xa.dtype == xb.dtype == np.float32
    assert xa.shape == (n if indices is None else len(indices), CROP, CROP, 3)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)
    return xa, ya


# ---------------------------------------------------------- metadata


def test_labels_and_solutions_match_jax(imagenet_root):
    (plt, ptab), (jlt, jtab) = (_tables(m, imagenet_root)
                                for m in (imagenet, jimagenet))
    assert plt.wnids == jlt.wnids == WNIDS
    assert plt.names == jlt.names and plt.class_idx == jlt.class_idx
    np.testing.assert_array_equal(ptab.image_ids, jtab.image_ids)
    np.testing.assert_array_equal(ptab.class_idx, jtab.class_idx)
    _, psub = _tables(imagenet, imagenet_root, classes=["n01484850"])
    _, jsub = _tables(jimagenet, imagenet_root, classes=["n01484850"])
    assert len(psub) == len(jsub) == len(SIZES)
    for i, n in ((0, 3), (2, 3)):
        np.testing.assert_array_equal(ptab.shard(i, n).image_ids,
                                      jtab.shard(i, n).image_ids)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_file_layout_matches_jax(split):
    ids = ["n01440764_7", "ILSVRC2012_val_00000001"]
    for i in ids:
        assert imagenet.relpath(i, split) == jimagenet.relpath(i, split)
        assert (imagenet.makepaths(i, "/r", split)
                == jimagenet.makepaths(i, "/r", split))


# ------------------------------------------------------- preprocessing


def _image(seed=1, h=75, w=90):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)


def test_preprocess_steps_match_jax(imagenet_root):
    path = os.path.join(imagenet_root, "ILSVRC/Data/CLS-LOC/train/"
                        f"{WNIDS[0]}/{WNIDS[0]}_0.JPEG")
    np.testing.assert_array_equal(preprocess.decode_image(path),
                                  jpre.decode_image(path))
    with open(path, "rb") as f:
        raw = f.read()
    np.testing.assert_array_equal(preprocess.decode_image(raw),
                                  jpre.decode_image(raw))
    img = _image()
    for size in (40, 64, 120):
        np.testing.assert_array_equal(
            preprocess.resize_smallest_dimension(img, size),
            jpre.resize_smallest_dimension(img, size))
    np.testing.assert_array_equal(preprocess.center_crop(img, 32),
                                  jpre.center_crop(img, 32))
    p = preprocess.sample_augment_params(np.random.default_rng(4), 16)
    np.testing.assert_array_equal(
        p, jpre.sample_augment_params(np.random.default_rng(4), 16))
    for row in p:
        np.testing.assert_array_equal(
            preprocess.random_resized_crop(img, CROP, row),
            jpre.random_resized_crop(img, CROP, row))


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("augment", [False, True])
def test_preprocess_matches_jax(compat, augment):
    img = _image(2)
    aug = (preprocess.sample_augment_params(np.random.default_rng(5), 1)[0]
           if augment else None)
    kw = dict(crop=CROP, resize=RESIZE, compat_double_normalize=compat,
              augment=aug)
    np.testing.assert_array_equal(preprocess.preprocess(img, **kw),
                                  jpre.preprocess(img, **kw))
    np.testing.assert_array_equal(preprocess.IMAGENET_MEAN, jpre.IMAGENET_MEAN)
    np.testing.assert_array_equal(preprocess.IMAGENET_STD, jpre.IMAGENET_STD)


# ------------------------------------------------------------- native


def test_native_builds_into_the_port(imagenet_root):
    """g++ builds the repository's ``native/fd_native.cpp`` into the
    port's git-ignored build directory, not into ``native/build/``."""
    assert native.available()
    assert native.lib_path().endswith(os.path.join(
        "fluxdistributed_tpu_torch", "_build", "libfdnative.so"))
    assert os.path.isfile(native.lib_path())
    assert native.lib_path() != jnative.lib_path()
    path = os.path.join(imagenet_root, "ILSVRC/Data/CLS-LOC/val/"
                        "ILSVRC2012_val_00000000.JPEG")
    np.testing.assert_array_equal(native.decode_jpeg_file(path),
                                  jnative.decode_jpeg_file(path))


@pytest.mark.parametrize("augment", [False, True])
def test_native_preprocess_matches_jax(augment):
    img = _image(6)
    aug = (preprocess.sample_augment_params(np.random.default_rng(7), 1)[0]
           if augment else None)
    for compat in (False, True):
        kw = dict(crop=CROP, resize=RESIZE, compat_double_normalize=compat,
                  augment=aug)
        np.testing.assert_array_equal(native.preprocess_rgb(img, **kw),
                                      jnative.preprocess_rgb(img, **kw))


def test_native_fallback_for_a_png_behind_a_jpeg_name(imagenet_root,
                                                      tmp_path):
    """A PNG behind a ``.JPEG`` name fails libjpeg and takes the PIL
    fallback (with its augmentation row); both packages agree."""
    from PIL import Image

    png = tmp_path / "odd.JPEG"
    Image.fromarray(_image(8)).save(png, format="PNG")
    good = os.path.join(imagenet_root, "ILSVRC/Data/CLS-LOC/val/"
                        "ILSVRC2012_val_00000001.JPEG")
    paths = [good, str(png)]
    augs = preprocess.sample_augment_params(np.random.default_rng(9), 2)
    outs = []
    for nat, pre in ((native, preprocess), (jnative, jpre)):
        outs.append(nat.load_batch(
            paths, crop=CROP, resize=RESIZE, num_threads=2, augs=augs,
            fallback=lambda p, aug=None, pre=pre: pre.preprocess(
                p, crop=CROP, resize=RESIZE, augment=aug)))
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="failed to load"):
        native.load_batch(paths, crop=CROP, resize=RESIZE)


# ------------------------------------------------------------ batches


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
@pytest.mark.parametrize("augment", [False, True], ids=["eval", "augment"])
def test_batch_equals_jax(imagenet_root, use_native, augment):
    """``ImageNetDataset.batch`` on the same rng: the same rows, the same
    augmentation draws, the same pixels."""
    port, ref = _pair(imagenet_root, use_native=use_native, augment=augment)
    with port, ref:
        x, y = _batches_equal(port, ref, n=6)
        assert np.isfinite(x).all() and set(y.tolist()) <= {0, 1, 2}
        _batches_equal(port, ref, indices=np.arange(len(port)))


def test_val_split_and_native_default(imagenet_root):
    """The val split reads the flat val layout and does not augment by
    default; the native backend is on where it builds, as in JAX."""
    port, ref = _pair(imagenet_root, split="val")
    with port, ref:
        assert port.augment is ref.augment is False
        assert port.use_native == ref.use_native == native.available()
        _batches_equal(port, ref, indices=np.arange(len(port)))


# ------------------------------------------------------------ sources


def test_make_source_dispatch(tmp_path):
    assert isinstance(sources.make_source(str(tmp_path)), sources.FileSource)
    assert isinstance(sources.make_source("http://x/y"), sources.HTTPSource)
    s = sources.make_source("gs://bucket/prefix", cache_dir=str(tmp_path))
    assert isinstance(s, sources.GCSSource)
    assert s.base_url == "https://storage.googleapis.com/bucket/prefix"
    assert s.location == "gs://bucket/prefix"
    j = jsources.make_source("gs://bucket/prefix", cache_dir=str(tmp_path))
    assert s.cache_dir == j.cache_dir
    with pytest.raises(ValueError):
        sources.GCSSource("s3://nope")


def test_http_source_serves_the_batches_of_the_local_tree(
        imagenet_root, http_root, tmp_path):
    """An ImageNet dataset whose ``path`` is an http URL fetches each
    file once into the cache (atomic renames) and gives the local tree's
    batches, bit for bit."""
    base, requests = http_root
    src = sources.HTTPSource(base, cache_dir=str(tmp_path / "cache"))
    rel = "LOC_synset_mapping.txt"
    local = src.local_path(rel)
    with open(local, "rb") as a, open(os.path.join(imagenet_root, rel),
                                      "rb") as b:
        assert a.read() == b.read()
    n = len(requests)
    assert src.local_path(rel) == local and len(requests) == n
    lt, table = _tables(imagenet, imagenet_root)
    remote = imagenet.ImageNetDataset(src, table, nclasses=len(lt), crop=CROP,
                                      resize=RESIZE, num_threads=2)
    loc, _ = _pair(imagenet_root)
    with remote, loc:
        assert remote.root == base
        _batches_equal(remote, loc, n=5)
    assert not any(f.endswith(".part") for _, _, fs in
                   os.walk(tmp_path / "cache") for f in fs)


def test_fetch_artifact_and_checkpoint(http_root, imagenet_root, tmp_path):
    base, requests = http_root
    assert sources.fetch_artifact(imagenet_root) == imagenet_root
    got = sources.fetch_artifact(f"{base}/LOC_val_solution.csv",
                                 cache_dir=str(tmp_path / "c"))
    with open(got) as f:
        assert f.read().startswith("ImageId,PredictionString")
    # a zipped checkpoint directory is fetched and unpacked once
    ck = os.path.join(imagenet_root, "ckpt.zip")
    with zipfile.ZipFile(ck, "w") as zf:
        zf.writestr("run/step_0/params.bin", b"\x00" * 8)
    try:
        out = sources.fetch_checkpoint(f"{base}/ckpt.zip",
                                       cache_dir=str(tmp_path / "c"))
        assert os.path.isfile(os.path.join(out, "step_0", "params.bin"))
        n = len(requests)
        assert sources.fetch_checkpoint(f"{base}/ckpt.zip",
                                        cache_dir=str(tmp_path / "c")) == out
        assert len(requests) == n
    finally:
        os.unlink(ck)


# ----------------------------------------------------------- registry


def _toml(tmp_path, root, prefix):
    p = tmp_path / f"{prefix}.toml"
    p.write_text(f"""
[[datasets]]
name = "{prefix}_train"
driver = "imagenet"
path = "{root}"
crop = {CROP}
resize = {RESIZE}
num_threads = 2

[[datasets]]
name = "{prefix}_val"
driver = "imagenet"
path = "{root}"
split = "val"
crop = {CROP}
resize = {RESIZE}
num_threads = 2

[[datasets]]
name = "{prefix}_fake"
driver = "synthetic"
nsamples = 64
nclasses = 5
shape = [8, 8, 3]
""")
    return str(p)


def test_registry_toml_and_overrides_match_jax(imagenet_root, tmp_path):
    toml = _toml(tmp_path, imagenet_root, "reg")
    registry.load_registry(toml)
    jregistry.load_registry(toml)
    assert set(registry.DRIVERS) == set(jregistry.DRIVERS)
    assert registry.driver_of("reg_train") == "imagenet"
    for name, kw in (("reg_train", {}), ("reg_train", {"augment": False}),
                     ("reg_val", {}), ("reg_train", {"use_native": False})):
        port = registry.open_dataset(name, **kw)
        ref = jregistry.open_dataset(name, **kw)
        with port, ref:
            assert (port.augment, port.use_native, port.table.split) == (
                ref.augment, ref.use_native, ref.table.split)
            _batches_equal(port, ref, n=4)
    fake = registry.open_dataset("reg_fake")
    assert isinstance(fake, data.SyntheticDataset) and fake.nclasses == 5
    with pytest.raises(KeyError, match="not registered"):
        registry.open_dataset("nope")
    with pytest.raises(KeyError, match="not registered"):
        registry.driver_of("nope")
    with pytest.raises(ValueError, match="unknown driver"):
        registry.register_dataset("bad", "imaginary")


def test_remote_imagenet_through_the_registry(imagenet_root, http_root,
                                              tmp_path):
    base, _ = http_root
    registry.register_dataset("remote_inet", "imagenet", path=base,
                              cache_dir=str(tmp_path / "c"), crop=CROP,
                              resize=RESIZE, num_threads=2, augment=False)
    remote = registry.open_dataset("remote_inet")
    loc, _ = _pair(imagenet_root, augment=False)
    with remote, loc:
        _batches_equal(remote, loc, n=4)


# ---------------------------------------------------------------- CLI


def test_cli_trains_on_a_registered_imagenet(imagenet_root, tmp_path,
                                             capsys):
    """``--data-toml``, a registered ``--dataset``, ``--val-dataset`` and
    ``--final-eval``: two steps on the CPU, the val slice at the eval
    cadence and the whole val split at the end."""
    toml = _toml(tmp_path, imagenet_root, "cli")
    task = cli.run(["--data-toml", toml, "--dataset", "cli_train",
                    "--val-dataset", "cli_val", "--final-eval",
                    "--model", "vit_tiny", "--image-size", str(CROP),
                    "--batch-size", "4", "--cycles", "2", "--eval-every", "1",
                    "--opt", "adamw", "--lr", "1e-3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(task.losses) == 2 and np.isfinite(task.losses).all()
    assert "3 classes" in out and "val_top1=" in out
    line = [x for x in out.splitlines() if x.startswith("final eval:")]
    assert len(line) == 1 and "samples=6" in line[0] and "exact=True" in \
        line[0] and "top5=" in line[0]


def _cifar(tmp_path):
    rng = np.random.default_rng(0)
    base = tmp_path / "cifar-10-batches-bin"
    base.mkdir()
    for fname in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        recs = [np.concatenate([[lbl], rng.integers(0, 255, 3072)]).astype(
            np.uint8) for lbl in (3, 7)]
        np.stack(recs).tofile(base / fname)
    return str(tmp_path)


def test_cli_cifar_alias_goes_through_the_registry(tmp_path):
    """``cifar:PATH`` (the port's form) registers a ``cifar10`` entry
    under its own name and opens it as the JAX CLI opens a registered
    dataset."""
    path = _cifar(tmp_path)
    task = cli.run(["--dataset", f"cifar:{path}", "--model", "SimpleCNN",
                    "--batch-size", "4", "--cycles", "2", "--eval-every",
                    "0", "--device", "cpu"])
    assert len(task.losses) == 2
    assert registry.driver_of(f"cifar:{path}") == "cifar10"
    assert isinstance(registry.open_dataset(f"cifar:{path}"),
                      data.CIFAR10Dataset)


def test_cli_dataset_refusals(imagenet_root, tmp_path):
    base = ["--cycles", "1", "--device", "cpu"]
    toml = _toml(tmp_path, imagenet_root, "ref")
    for argv, match in [
            (["--final-eval"], "--final-eval needs --val-dataset"),
            (["--val-dataset", "nope"], "not registered"),
            (["--dataset", "nope"], "not registered"),
            (["--data-toml", toml, "--dataset", "ref_train", "--model",
              "lm_tiny"], "trains on tokens")]:
        with pytest.raises(SystemExit, match=match):
            cli.run(argv + base)
