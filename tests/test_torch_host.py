"""The host's CPU model in the port's records: utils/general.cpu_model,
refscale/common.device_record (every reference-scale record, the bench's
stderr) and the native library's build key."""

import platform
import types

import torch

from gaustar_tpu_torch import native
from gaustar_tpu_torch.refscale import common
from gaustar_tpu_torch.utils import general


def test_cpu_model_reads_the_first_model_name(monkeypatch, tmp_path):
    info = tmp_path / "cpuinfo"
    info.write_text("processor\t: 0\nvendor_id\t: GenuineIntel\nmodel name\t: Intel(R) Xeon(R) Platinum 8480C\n"
                    "processor\t: 1\nmodel name\t: Other CPU\n")
    real_open = open
    monkeypatch.setattr(general, "open", lambda path, *a, **k: real_open(info if path == "/proc/cpuinfo" else path,
                                                                        *a, **k), raising=False)
    assert general.cpu_model() == "Intel(R) Xeon(R) Platinum 8480C"


def test_cpu_model_without_a_model_name(monkeypatch, tmp_path):
    info = tmp_path / "cpuinfo"
    info.write_text("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\nmodel\t\t: 143\n"
                    "model name\t: unknown\nstepping\t: unknown\ncpu MHz\t\t: 2000.000\n\n"
                    "processor\t: 1\nvendor_id\t: Other\n")
    real_open = open
    monkeypatch.setattr(general, "open", lambda path, *a, **k: real_open(info if path == "/proc/cpuinfo" else path,
                                                                        *a, **k), raising=False)
    assert general.cpu_model() == ("vendor_id GenuineIntel, cpu family 6, model 143, cpu MHz 2000.000 "
                                   "(no model name)")


def test_cpu_model_without_cpuinfo_is_the_architecture(monkeypatch):
    def no_file(*a, **k):
        raise OSError("no /proc here")

    monkeypatch.setattr(general, "open", no_file, raising=False)
    assert general.cpu_model() == platform.machine()


def test_device_record_carries_the_host(monkeypatch):
    assert common.device_record(torch.device("cpu")) == {"device": "cpu", "host_cpu": general.cpu_model()}
    smi = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(common.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=smi + "\n", returncode=0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(common, "cpu_model", lambda: "Test CPU")
    assert common.device_record(torch.device("cuda", 0)) == {
        "device": "NVIDIA H100 80GB HBM3", "nvidia_smi": smi, "host_cpu": "Test CPU"}


def test_native_build_is_keyed_by_the_host(monkeypatch):
    here = native.lib_path()
    monkeypatch.setattr(native, "cpu_model", lambda: "Another CPU")
    assert native.lib_path() != here and native.lib_path().parent == here.parent
