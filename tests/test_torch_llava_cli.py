"""llava_cli.main against the JAX tool on the CPU, in f32 (ForwardOptions
and the bf16 caches patched to f32 in both packages): the trained tiny
pair's target with a tiny mmproj, for the flat (llava-1.5, an image padded
to square) and minicpmv (an image cut into a 2 x 1 grid of slices)
projectors, equal stdout and the same image line; the marker-count error."""

import numpy as np
import pytest

from prima_tpu.tools import llava_cli as jllava_cli
from prima_tpu_torch.tools import llava_cli
from test_torch_cli import f32  # noqa: F401
from test_torch_llava import TARGET, mmproj  # noqa: F401
from test_torch_tools_quant import f32_cache  # noqa: F401


@pytest.mark.parametrize("kind,shape", [("flat", (40, 24, 3)), ("minicpmv", (300, 700, 3))])
def test_llava_cli_matches_jax(f32, f32_cache, mmproj, tmp_path, capsys, kind, shape):
    img = str(tmp_path / "img.npy")
    np.save(img, np.random.default_rng(4).integers(0, 255, shape, dtype=np.uint8))
    args = ["-m", TARGET, "--mmproj", mmproj[kind], "--image", img,
            "-p", "<image>\nOnce upon a time, there was a", "-n", "8", "--temp", "0", "-c", "512"]
    assert jllava_cli.main(args + ["--matmul", "xla"]) == 0
    jcap = capsys.readouterr()
    assert llava_cli.main(args + ["--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert cap.out == jcap.out and len(cap.out.strip()) > 0
    image_line = [ln for ln in cap.err.splitlines() if ln.startswith("image: ")]
    assert image_line == [ln for ln in jcap.err.splitlines() if ln.startswith("image: ")] != []


def test_llava_cli_marker_count_error(mmproj, tmp_path, capsys):
    img = str(tmp_path / "a.npy")
    np.save(img, np.zeros((8, 8, 3), np.uint8))
    args = ["-m", TARGET, "--mmproj", mmproj["flat"], "--image", img, "--image", img,
            "-p", "one <image> only"]
    assert llava_cli.main(args + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert jllava_cli.main(args + ["--matmul", "xla"]) == 1
    assert "error: prompt has 1 <image> markers but 2 --image args" in err
    assert err.splitlines()[-1] == capsys.readouterr().err.splitlines()[-1]
