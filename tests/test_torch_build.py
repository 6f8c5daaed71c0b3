"""The kernel build's cache key (``edl_tpu_torch/ops/_build.py``), on the
CPU: no compiler is needed to say where a set of sources builds to."""

import shutil

from edl_tpu_torch.ops import _build


def test_build_dir_follows_every_file_under_csrc(tmp_path):
    """A header that no list names still keys the build: adding one, or
    editing one, moves the build directory; an unchanged copy keeps it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    base = _build.build_dir(csrc)
    assert base == _build.build_dir(_build.CSRC)
    (csrc / "extra_helpers.cuh").write_text("#pragma once\n")
    added = _build.build_dir(csrc)
    assert added != base
    (csrc / "extra_helpers.cuh").write_text("#pragma once\n// edited\n")
    assert _build.build_dir(csrc) not in (base, added)
    (csrc / "extra_helpers.cuh").unlink()
    assert _build.build_dir(csrc) == base


def test_ptxas_report_reads_each_kernel(tmp_path):
    """Registers, static shared memory and spills per kernel, from the log
    that ``build`` keeps beside each library."""
    (tmp_path / "flash_fwd.log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1av\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 600 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 16 bytes smem, 400 bytes cmem[0]\n")
    assert _build.ptxas_report("flash_fwd", tmp_path) == [
        dict(kernel="_Z1av", registers=168, static_smem_bytes=0,
             spill_store_bytes=8, spill_load_bytes=4),
        dict(kernel="_Z1bv", registers=40, static_smem_bytes=16,
             spill_store_bytes=0, spill_load_bytes=0)]
