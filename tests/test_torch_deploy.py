"""The port as it is deployed: ``Dockerfile.torch``, the
``deploy/overlays/h100`` overlay rendered in Python
(``operator_tpu_torch/utils/manifests.py``: kustomize's strategic merge,
``env`` merged by name, ``$patch: delete`` and null honoured), and the
serving entry point under the kubelet's SIGTERM.

The overlay's two Deployments must run the port's entry points on one
H100 (``nvidia.com/gpu: "1"``, no TPU resource or GKE TPU label, no
``SERVING_MESH``), with a ``startupProbe`` and only environment entries
the port reads.  The image must install what the port imports and no
``jax``, copy the port and not the JAX package, pre-build the kernels
into the directory ``OPERATOR_TPU_TORCH_BUILD_DIR`` names, and run as
user 1001.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import shlex
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import yaml

from operator_tpu_torch.utils import manifests
from operator_tpu_torch.utils.config import OperatorConfig

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "operator_tpu_torch"
OVERLAY = REPO / "deploy" / "overlays" / "h100"
DOCKERFILE = REPO / "Dockerfile.torch"
DEPLOYMENTS = {"podmortem-tpu-operator": "operator_tpu_torch.operator",
               "podmortem-serving": "operator_tpu_torch.serving"}
GKE_TPU_KEYS = ("cloud.google.com/gke-tpu-accelerator", "cloud.google.com/gke-tpu-topology")
#: import name -> the distribution pip installs it from
DISTRIBUTIONS = {"yaml": "pyyaml"}


@pytest.fixture(scope="module")
def rendered() -> list:
    return manifests.render(str(OVERLAY))


@pytest.fixture(scope="module")
def stages() -> list:
    return manifests.read_dockerfile(str(DOCKERFILE))


def _spec(rendered: list, name: str) -> dict:
    return manifests.deployment(rendered, name)["spec"]["template"]["spec"]


def _names_read_from_the_environment() -> set:
    """Every environment name the port reads: a string literal passed to
    ``.get``/``getenv``/``pop``/``setdefault`` or subscripting
    ``environ``, or a literal bound to a name that a ``.get`` in the same
    function reads (``OperatorConfig.from_env``'s aliases)."""
    names: set = set()
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args:
                func = node.func
                called = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
                first = node.args[0]
                if called in ("get", "getenv", "pop", "setdefault"):
                    if isinstance(first, ast.Constant) and isinstance(first.value, str):
                        names.add(first.value)
            elif isinstance(node, ast.Subscript):
                base = node.value
                if (isinstance(base, ast.Attribute) and base.attr == "environ"
                        and isinstance(node.slice, ast.Constant)):
                    names.add(node.slice.value)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                read = {arg.id for call in ast.walk(node) if isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute) and call.func.attr == "get"
                        for arg in call.args[:1] if isinstance(arg, ast.Name)}
                for assign in ast.walk(node):
                    if (isinstance(assign, ast.Assign) and isinstance(assign.value, ast.Constant)
                            and isinstance(assign.value.value, str)
                            and any(isinstance(t, ast.Name) and t.id in read
                                    for t in assign.targets)):
                        names.add(assign.value.value)
    return names


def _third_party_imports() -> set:
    roots = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                found = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                found = [node.module]
            else:
                continue
            for name in found:
                root = name.split(".")[0]
                if root not in sys.stdlib_module_names and root != "operator_tpu_torch":
                    roots.add(root)
    return roots


def _pip_installs(stage) -> set:
    """The requirement names of every ``pip install`` in ``stage``."""
    names = set()
    for run in stage.runs:
        for command in re.split(r"&&|;", run):
            words = shlex.split(command)
            if words[:2] != ["pip", "install"]:
                continue
            skip = False
            for word in words[2:]:
                if skip:
                    skip = False
                elif word in ("--index-url", "-i", "--extra-index-url", "-f"):
                    skip = True
                elif not word.startswith("-"):
                    names.add(re.split(r"[<>=\[ ]", word, maxsplit=1)[0].lower())
    return names


# ---------------------------------------------------------------------------
# the strategic merge
# ---------------------------------------------------------------------------


MERGE_CASES = {
    "env_by_name": (
        {"env": [{"name": "A", "value": "1"}, {"name": "B", "value": "2"}]},
        {"env": [{"name": "B", "value": "3"}, {"name": "C", "value": "4"}]},
        {"env": [{"name": "A", "value": "1"}, {"name": "B", "value": "3"},
                 {"name": "C", "value": "4"}]},
    ),
    "patch_delete": (
        {"env": [{"name": "A", "value": "1"}, {"name": "B", "value": "2"}]},
        {"env": [{"name": "A", "$patch": "delete"}]},
        {"env": [{"name": "B", "value": "2"}]},
    ),
    "null_deletes_a_key": (
        {"nodeSelector": {"a": "1", "b": "2"}},
        {"nodeSelector": {"a": None, "c": "3"}},
        {"nodeSelector": {"b": "2", "c": "3"}},
    ),
    "list_without_merge_key_replaced": (
        {"command": ["python", "-m", "operator_tpu.serving"]},
        {"command": ["python", "-m", "operator_tpu_torch.serving"]},
        {"command": ["python", "-m", "operator_tpu_torch.serving"]},
    ),
    "containers_by_name_nested": (
        {"containers": [{"name": "c", "image": "a", "resources": {"limits": {"x": "4"}}}]},
        {"containers": [{"name": "c", "resources": {"limits": {"x": None, "y": "1"}}}]},
        {"containers": [{"name": "c", "image": "a", "resources": {"limits": {"y": "1"}}}]},
    ),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_strategic_merge_follows_kubernetes_rules(case):
    base, patch, want = MERGE_CASES[case]
    before = json.dumps(base)
    assert manifests.merge(base, patch) == want
    assert json.dumps(base) == before  # the base is not changed


def test_the_renderer_agrees_with_the_openshift_overlays_check():
    """The OpenShift overlay through the renderer: what
    ``tests/test_deploy.py`` checks of it by hand."""
    objects = manifests.render(str(REPO / "deploy" / "overlays" / "openshift"))
    spec = _spec(objects, "podmortem-tpu-operator")
    assert not any(key in spec.get("nodeSelector", {}) for key in GKE_TPU_KEYS)
    context = manifests.container(manifests.deployment(objects, "podmortem-tpu-operator"))[
        "securityContext"]
    assert "runAsUser" not in context and context["runAsNonRoot"] is True
    assert context["capabilities"] == {"drop": ["ALL"]}
    assert any(o["kind"] == "Route" for o in objects)
    # the serving Deployment is the base's, untouched
    base = yaml.safe_load((REPO / "deploy" / "serving-deployment.yaml").read_text())
    assert manifests.deployment(objects, "podmortem-serving")["spec"] == base["spec"]


# ---------------------------------------------------------------------------
# the overlay
# ---------------------------------------------------------------------------


def test_the_overlay_renders_the_base_with_two_patches(rendered):
    kustomization = yaml.safe_load((OVERLAY / "kustomization.yaml").read_text())
    assert kustomization["resources"] == ["../../"]
    base = manifests.render(str(REPO / "deploy"))
    assert [(o["kind"], o["metadata"]["name"]) for o in rendered] == \
        [(o["kind"], o["metadata"]["name"]) for o in base]
    changed = [o["metadata"]["name"] for o, b in zip(rendered, base) if o != b]
    assert sorted(changed) == sorted(DEPLOYMENTS)


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_the_command_runs_a_port_entry_point(rendered, name):
    command = manifests.container(manifests.deployment(rendered, name))["command"]
    assert command[:2] == ["python", "-m"] and command[2] == DEPLOYMENTS[name]
    module = command[2].split(".")
    assert (REPO.joinpath(*module) / "__main__.py").is_file()
    assert "operator_tpu." not in " ".join(command) + "."


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_no_tpu_resource_or_gke_tpu_label_is_left(rendered, name):
    obj = manifests.deployment(rendered, name)
    text = json.dumps(obj)
    assert "google.com/tpu" not in text
    assert "gke-tpu" not in text
    spec = obj["spec"]["template"]["spec"]
    assert spec["nodeSelector"] == {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    assert {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"} in \
        spec["tolerations"]


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_one_gpu_is_requested_and_limited(rendered, name):
    resources = manifests.container(manifests.deployment(rendered, name))["resources"]
    assert resources["requests"]["nvidia.com/gpu"] == "1"
    assert resources["limits"]["nvidia.com/gpu"] == "1"
    assert resources["limits"]["memory"].endswith("Gi")


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_no_serving_mesh(rendered, name):
    env = manifests.container(manifests.deployment(rendered, name))["env"]
    assert "SERVING_MESH" not in {e["name"] for e in env}


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_a_startup_probe_guards_the_cold_start(rendered, name):
    container = manifests.container(manifests.deployment(rendered, name))
    probe = container["startupProbe"]
    ports = {p["name"] for p in container["ports"]}
    assert probe["httpGet"]["port"] in ports
    # the probe's path is the one liveness checks after it
    assert probe["httpGet"]["path"] == container["livenessProbe"]["httpGet"]["path"]
    assert probe["periodSeconds"] * probe["failureThreshold"] >= 60


@pytest.mark.parametrize("name", sorted(DEPLOYMENTS))
def test_every_env_name_is_one_the_port_reads(rendered, name):
    read = ({f.name.upper() for f in dataclasses.fields(OperatorConfig)}
            | _names_read_from_the_environment())
    env = manifests.container(manifests.deployment(rendered, name))["env"]
    unread = sorted({e["name"] for e in env} - read)
    assert not unread, unread


def test_the_env_scan_finds_the_names_it_must():
    read = _names_read_from_the_environment()
    # literal reads, and from_env's one alias of a field's name
    assert {"OPERATOR_TPU_TORCH_BUILD_DIR", "POD_NAME", "PODMORTEM_WATCH_NAMESPACES"} <= read
    assert "OPERATOR_TPU_XLA_CACHE_DIR" not in read


# ---------------------------------------------------------------------------
# the image
# ---------------------------------------------------------------------------


def test_the_image_has_a_cuda_build_stage_and_a_python_312_runtime(stages):
    build, runtime = stages
    assert re.fullmatch(r"nvidia/cuda:12\.\d+(\.\d+)?-devel-ubuntu\d\d\.\d\d", build.base)
    assert runtime.base.startswith("python:3.12")


@pytest.mark.parametrize("root", sorted(_third_party_imports()))
def test_the_runtime_installs_each_third_party_import(stages, root):
    assert DISTRIBUTIONS.get(root, root) in _pip_installs(stages[-1])


def test_the_port_imports_only_numpy_torch_and_yaml():
    assert _third_party_imports() == {"numpy", "torch", "yaml"}


def test_the_runtime_installs_a_cuda_torch_and_no_jax(stages):
    runtime = stages[-1]
    installed = _pip_installs(runtime)
    assert not {"jax", "jaxlib", "safetensors", "transformers", "tokenizers"} & installed
    assert installed == {"torch", "numpy", "pyyaml"}
    assert any("download.pytorch.org/whl/cu12" in run for run in runtime.runs)
    assert "jax" not in DOCKERFILE.read_text().replace("no jax", "")


@pytest.mark.parametrize("stage", [0, 1])
def test_the_image_copies_the_port_and_not_the_jax_package(stages, stage):
    sources = [s for sources, _, origin in stages[stage].copies if origin is None
               for s in sources]
    assert "operator_tpu_torch/" in sources
    assert not any(s.rstrip("/") == "operator_tpu" for s in sources)
    assert "native/logscan.cpp" in sources


def test_the_build_stage_prebuilds_every_kernel_into_the_build_dir(stages):
    build, runtime = stages
    directory = build.env["OPERATOR_TPU_TORCH_BUILD_DIR"]
    assert directory.startswith("/")
    assert build.runs[-1] == "python3 -m operator_tpu_torch.ops"
    main = ast.parse((PORT / "ops" / "__main__.py").read_text())
    calls = {node.func.attr for node in ast.walk(main)
             if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)}
    assert {"build_all", "_build_library"} <= calls
    # the runtime copies that directory from the build stage and names it
    assert ([directory], directory, build.name) in runtime.copies
    assert runtime.env["OPERATOR_TPU_TORCH_BUILD_DIR"] == directory


def test_the_runtime_runs_the_operator_as_user_1001(stages):
    runtime = stages[-1]
    assert runtime.user == "1001"
    assert runtime.entrypoint == ["python", "-m", "operator_tpu_torch.operator"]
    assert runtime.workdir == "/app"


# ---------------------------------------------------------------------------
# SIGTERM drains the serving entry point
# ---------------------------------------------------------------------------


def _read_until(stream, pattern: str, lines: list, timeout_s: float) -> re.Match:
    """Lines of ``stream`` into ``lines`` until one matches (on a thread,
    so a silent process cannot hang the test)."""
    found: list = []
    done = threading.Event()

    def pump():
        for line in stream:
            lines.append(line)
            if not found:
                match = re.search(pattern, line)
                if match:
                    found.append(match)
                    done.set()
        done.set()

    threading.Thread(target=pump, daemon=True).start()
    done.wait(timeout_s)
    assert found, "".join(lines)[-3000:]
    return found[0]


def test_sigterm_drains_a_request_in_flight_and_exits_0(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "SERVING_MESH"}
    # one CPU thread: tiny-test's matmuls gain nothing from more, and a
    # thread per core on a loaded host stretches the 160 tokens past the
    # server's 30 s drain grace
    env.update(OPERATOR_TPU_MODEL="tiny-test", ALLOW_RANDOM_WEIGHTS="true",
               MAX_BATCH_SIZE="4", KV_PAGE_SIZE="16", OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
               OPERATOR_TPU_TORCH_BUILD_DIR=str(tmp_path / "kernels"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "operator_tpu_torch.serving", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: list = []
    try:
        port = int(_read_until(proc.stdout, r"listening on 127\.0\.0\.1:(\d+)", lines, 120)
                   .group(1))
        body = json.dumps({"prompt": "pod crashed with exit code 137", "max_tokens": 160,
                           "temperature": 0.0, "stream": True}).encode()
        request = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=60) as response:
            status = response.status
            first = response.readline()
            proc.send_signal(signal.SIGTERM)
            terminated = time.monotonic()
            rest = response.read().decode()
        rc = proc.wait(60)
        exit_s = time.monotonic() - terminated
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    chunks = [json.loads(line[len("data: "):]) for line in rest.splitlines()
              if line.startswith("data: {")]
    assert status == 200
    assert first.startswith(b"data: {")
    # the stream went on after SIGTERM, to its end
    assert chunks and rest.rstrip().endswith("data: [DONE]")
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")
    assert rc == 0, "".join(lines)[-3000:]
    assert exit_s < 40
