"""The port's serving image files (``deploy/Dockerfile.torch``,
``deploy/requirements.torch.txt``, ``deploy/render.torch.yaml``), read as
text: the tests do not build the image."""

import ast
import importlib.util
import json
import os
import re
import sys

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy")


def _read(name):
    with open(os.path.join(REPO, name)) as f:
        return f.read()


def _instructions(text):
    """Dockerfile instructions, continuation lines joined, comments out."""
    joined = re.sub(r"\\\n", " ", "\n".join(
        ln for ln in text.splitlines() if not ln.lstrip().startswith("#")))
    return [ln.strip() for ln in joined.splitlines() if ln.strip()]


def _of(kind, text):
    return [ln.split(None, 1)[1] for ln in _instructions(text)
            if ln.split(None, 1)[0] == kind]


def _requirements():
    names = []
    for line in _read("deploy/requirements.torch.txt").splitlines():
        line = line.split("#")[0].strip()
        if line:
            names.append(re.split(r"[<>=!~\[; ]", line)[0].lower())
    return names


def test_image_copies_the_port_and_not_avd_tpu():
    copies = [c.split() for c in _of("COPY", _read("deploy/Dockerfile.torch"))]
    sources = [s.rstrip("/") for c in copies for s in c[:-1]]
    assert "avd_tpu_torch" in sources
    assert "avd_tpu" not in sources
    assert "deploy/requirements.torch.txt" in sources


def test_image_cmd_module_resolves():
    (cmd,) = _of("CMD", _read("deploy/Dockerfile.torch"))
    argv = json.loads(cmd)
    assert argv[:2] == ["python", "-m"]
    assert argv[2] == "avd_tpu_torch.serve.master"
    assert importlib.util.find_spec(argv[2]) is not None
    assert argv[3:] == ["--device", "cuda"]


def test_image_base_and_settings():
    text = _read("deploy/Dockerfile.torch")
    (base,) = _of("FROM", text)
    assert base.startswith("nvidia/cuda:12.8") and "-devel-" in base
    assert "AVD_XLA_CACHE_DIR" not in text
    env = " ".join(_of("ENV", text))
    assert "AVD_NATIVE_CACHE=" in env
    # the same health check as the root Dockerfile's
    assert _of("HEALTHCHECK", text) == _of("HEALTHCHECK", _read("Dockerfile"))


def test_requirements_name_no_jax():
    names = _requirements()
    assert "torch" in names
    assert not [n for n in names if n.startswith(("jax", "orbax", "optax"))]


def _third_party_imports():
    """Top-level modules the port imports that are neither the standard
    library nor the port itself."""
    found = set()
    for root, _, files in os.walk(os.path.join(REPO, "avd_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    found.update(a.name.split(".")[0] for a in node.names)
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    found.add(node.module.split(".")[0])
    return found - set(sys.stdlib_module_names) - {"avd_tpu_torch"}


def test_requirements_cover_the_ports_imports():
    dist = {"cv2": "opencv-python-headless"}
    optional = {"yt_dlp"}  # the URL resolver falls back without it
    wanted = {dist.get(m, m) for m in _third_party_imports() - optional}
    assert wanted <= set(_requirements()), wanted - set(_requirements())


def test_render_descriptor_env_keys_equal():
    with open(os.path.join(DEPLOY, "render.yaml")) as f:
        ref = yaml.safe_load(f)["services"][0]
    with open(os.path.join(DEPLOY, "render.torch.yaml")) as f:
        port = yaml.safe_load(f)["services"][0]
    assert port["envVars"] == ref["envVars"]
    assert port["healthCheckPath"] == ref["healthCheckPath"]
    assert port["name"] != ref["name"] and "gpu" in port["name"]
    assert port["dockerfilePath"] == "./deploy/Dockerfile.torch"
