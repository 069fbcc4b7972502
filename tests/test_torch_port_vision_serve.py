"""Port parity: the vision inference server
(``fluxdistributed_tpu_torch/serve/vision.py``, the default mode of the
JAX package's ``bin/serve.py``) and the inference CLI
(``fluxdistributed_tpu_torch/infer.py``, the JAX ``bin/infer.py``).

The test writes its own torchvision-named ResNet-18 weights file (the
port's ``state_dict``, whose names are torchvision's, with the head
scaled so that the top classes stand apart), its own synset file and
its own JPEG; nothing is downloaded.  ``predict`` on one JPEG gives the
JAX ``make_app``'s top-3 labels on the same weights file, with
probabilities within 0.03 (both compute in bfloat16, whose roundings
the two frameworks place differently); the HTTP front end serves the
page, answers 400 to a payload that is not an image and 404 to an
unknown path; ``predict.from_array`` on the decoded image gives
``predict``'s answer.  The LM mode of the serve CLI loads a trainer
checkpoint's params.  The infer CLI reads a trainer checkpoint and
prints the model's own top-k.
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "bin"))

NCLS = 10
NAMES = [f"n{i:08d} thing{i}, other name" for i in range(NCLS)]


def _jpeg_bytes(seed=0, shape=(240, 320, 3)) -> bytes:
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A torchvision-named ResNet-18 weights file and a synset file."""
    from fluxdistributed_tpu_torch.models import resnet18

    d = tmp_path_factory.mktemp("vision_serve")
    model = resnet18(num_classes=NCLS, device="cpu", seed=4)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd["fc.weight"] = sd["fc.weight"] * 30.0
    torch.save(sd, d / "r18.pt")
    (d / "synset.txt").write_text("\n".join(NAMES) + "\n")
    return d


def _port_args(**kw):
    base = dict(model="resnet18", num_classes=NCLS, checkpoint=None,
                step=None, torch_weights=None, synset=None, topk=3,
                device="cpu", host="127.0.0.1", port=0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def apps(files):
    import serve as jserve

    from fluxdistributed_tpu_torch.serve.vision import make_app

    jargs = jserve.build_parser().parse_args(
        ["--model", "resnet18", "--num-classes", str(NCLS), "--topk", "3",
         "--torch-weights", str(files / "r18.pt"),
         "--synset", str(files / "synset.txt"), "--port", "0"])
    port = make_app(_port_args(torch_weights=str(files / "r18.pt"),
                               synset=str(files / "synset.txt")))
    return port, jserve.make_app(jargs)


def test_predict_matches_jax_make_app(apps):
    port, jax_predict = apps
    for seed in (0, 1):
        data = _jpeg_bytes(seed)
        got, want = port(data), jax_predict(data)
        assert [p["label"] for p in got] == [p["label"] for p in want]
        np.testing.assert_allclose([p["prob"] for p in got],
                                   [p["prob"] for p in want], atol=0.03)
        assert got[0]["label"] == NAMES[int(got[0]["label"][5:])].split(
            " ", 1)[1].split(",")[0]
    from fluxdistributed_tpu_torch.data.preprocess import decode_image

    assert port.from_array(decode_image(_jpeg_bytes(0))) == port(
        _jpeg_bytes(0))


def test_http_page_predict_400_and_404(apps):
    from fluxdistributed_tpu_torch.serve.vision import serve

    srv = serve(_port_args(), apps[0])
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/") as r:
            body = r.read().decode()
        assert "getUserMedia" in body and "/predict" in body
        req = urllib.request.Request(f"{url}/predict", data=_jpeg_bytes(),
                                     method="POST")
        with urllib.request.urlopen(req) as r:
            data = json.loads(r.read())
        assert data["predictions"] == apps[0](_jpeg_bytes())
        assert data["ms"] > 0
        req = urllib.request.Request(f"{url}/predict", data=b"not a jpeg",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 400 and "error" in json.loads(ei.value.read())
        for method, path in (("GET", "/nope"), ("POST", "/nope")):
            req = urllib.request.Request(f"{url}{path}", method=method,
                                         data=b"" if method == "POST" else None)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req)
            assert ei.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A ResNet-18 trained two steps with a checkpoint at the end."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import resnet18
    from fluxdistributed_tpu_torch.train import (NullLogger, prepare_training,
                                                 save_checkpoint, train)

    d = tmp_path_factory.mktemp("trained")
    model = resnet18(num_classes=NCLS, device="cpu", seed=2)
    ds = SyntheticDataset(nsamples=32, nclasses=NCLS, shape=(32, 32, 3))
    task = prepare_training(model, ds, optim.momentum(0.05), batch_size=8,
                            cycles=2, device="cpu")
    train(task, print_every=0, eval_every=0, logger=NullLogger())
    save_checkpoint(task.state, str(d), task.state.step)
    return d, model


def test_infer_cli_reads_a_trainer_checkpoint(trained, tmp_path, capsys):
    """``python -m fluxdistributed_tpu_torch.infer`` on a checkpoint:
    the printed table is the trained model's own top-3 on the eval
    pipeline's input, with the synset's names."""
    from PIL import Image

    from fluxdistributed_tpu_torch import infer
    from fluxdistributed_tpu_torch.data.preprocess import preprocess
    from fluxdistributed_tpu_torch.ops import showpreds

    ck, model = trained
    img = tmp_path / "img.jpg"
    img.write_bytes(_jpeg_bytes(3, (48, 64, 3)))
    syn = tmp_path / "syn.txt"
    syn.write_text("\n".join(NAMES) + "\n")
    rc = infer.main(["--model", "resnet18", "--num-classes", str(NCLS),
                     "--checkpoint", str(ck), "--synset", str(syn),
                     "--image-size", "32", "--resize", "36",
                     "--device", "cpu", str(img)])
    out = capsys.readouterr().out
    assert rc == 0 and "restored checkpoint step 2" in out
    x = preprocess(np.asarray(Image.open(img).convert("RGB")), crop=32,
                   resize=36)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x[None]))
    names = [n.split(" ", 1)[1].split(",")[0] for n in NAMES]
    assert showpreds(logits, class_names=names, k=3, names=[str(img)]) in out
    assert infer.main(["--model", "nope", "--device", "cpu"]) == 2
    assert infer.main(["--device", "cpu", "--model", "resnet18",
                       "--checkpoint", str(ck), "--torch-weights", "x"]) == 2


def test_serve_lm_mode_loads_a_checkpoint(tmp_path):
    """The serve CLI's LM mode takes a trainer checkpoint's params
    (``--checkpoint``, ``--step``); an image model selects the vision
    mode."""
    from fluxdistributed_tpu_torch.models import lm_tiny
    from fluxdistributed_tpu_torch.serve import __main__ as cli
    from fluxdistributed_tpu_torch.train import save_checkpoint

    src = lm_tiny(vocab=64, device="cpu", seed=5)
    save_checkpoint({"params": dict(src.named_parameters()), "step": 3},
                    str(tmp_path), 3)
    args = cli.build_parser().parse_args(
        ["--model", "lm_tiny", "--vocab", "64", "--checkpoint",
         str(tmp_path), "--step", "3", "--device", "cpu", "--max-slots",
         "2", "--max-len", "64", "--buckets", "16,64"])
    server, _ = cli.build_server(args)
    got = server.scheduler.engine.model.state_dict()
    for k, v in src.state_dict().items():  # the engine serves in bf16
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    assert cli.build_parser().parse_args(["--model", "resnet50"]).topk == 3
    with pytest.raises(SystemExit, match="image models"):
        cli.main(["--model", "lm_tiny", "--torch-weights", "x"])
