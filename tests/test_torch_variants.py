"""``chip_smoke.py --variant PATCH`` times kernel designs that were tried and
not shipped, kept as unified diffs under ``src/repro_torch/kernels/variants/``
against the tree they were written for: its ``apply_patch`` must rebuild
exactly the file a diff was made from, and refuse a diff whose context does
not match."""
import difflib
import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
VARIANTS = REPO / "src" / "repro_torch" / "kernels" / "variants"

_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

BASE = [f"line {i}" for i in range(40)]


def write_patch(tmp_path, old, new):
    (tmp_path / "f.cu").write_text("\n".join(old) + "\n")
    diff = difflib.unified_diff([ln + "\n" for ln in old], [ln + "\n" for ln in new],
                                "a/f.cu", "b/f.cu")
    patch = tmp_path / "v.patch"
    patch.write_text("".join(diff))
    return patch


@pytest.mark.parametrize("new", [
    ["first"] + BASE,                                          # an insertion at the top
    BASE[:10] + ["a", "b"] + BASE[10:25] + BASE[26:],          # two hunks: insert, delete
    BASE[:20] + ["changed"] + BASE[21:] + ["last"],            # a change and an append
    [ln.replace("1", "one") for ln in BASE],                   # many lines changed
    BASE[:39],                                                 # the last line removed
])
def test_apply_patch_rebuilds_the_new_file(tmp_path, new):
    patch = write_patch(tmp_path, BASE, new)
    cs.apply_patch(str(tmp_path), str(patch))
    assert (tmp_path / "f.cu").read_text() == "\n".join(new) + "\n"


def test_apply_patch_refuses_a_file_that_does_not_match(tmp_path):
    patch = write_patch(tmp_path, BASE, BASE[:5] + ["x"] + BASE[6:])
    (tmp_path / "f.cu").write_text("\n".join(["other"] + BASE[1:]).replace("line 5", "five")
                                   + "\n")
    with pytest.raises(SystemExit):
        cs.apply_patch(str(tmp_path), str(patch))


@pytest.mark.parametrize("patch", sorted(VARIANTS.glob("*.patch")), ids=lambda p: p.stem)
def test_variant_patches_name_a_kernel_source(patch):
    """Each variant replaces hunks of one kernel source of the port's csrc."""
    targets = [ln[4:].split("\t")[0] for ln in patch.read_text().splitlines()
               if ln.startswith("+++ ")]
    assert targets and all(t.startswith("b/src/repro_torch/kernels/csrc/") for t in targets)
    assert all((REPO / t[2:]).exists() for t in targets)
