"""The port's package surface against the reference's, on the CPU.

Every name in each reference package's ``__all__`` exists in the port's
counterpart package (a submodule named there may be imported from it), and
the decode cache's abstract form and logical axes equal the reference's for
every config, leaf by leaf, once the port's one dict a layer is stacked over
depth as the reference holds it (``convert.reference_layout``).
"""
import importlib
import pkgutil

import jax.numpy as jnp
import pytest

import repro
from repro.configs import ARCH_IDS as J_ARCH_IDS, get_config as j_config
from repro.models import abstract_cache as j_abstract_cache
from repro.models import cache_logical_axes as j_cache_logical_axes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import _leaves, reference_layout
from repro_torch.models import abstract_cache, cache_logical_axes


def reference_packages() -> list[str]:
    names = ["repro"]
    for info in pkgutil.walk_packages(repro.__path__, "repro."):
        if info.ispkg:
            names.append(info.name)
    return names


PACKAGES = [name for name in reference_packages()
            if hasattr(importlib.import_module(name), "__all__")]


def test_every_reference_package_with_an_all_is_listed():
    assert {"repro.configs", "repro.models", "repro.training", "repro.kernels", "repro.api",
            "repro.core", "repro.serving", "repro.launch"} <= set(PACKAGES)


@pytest.mark.parametrize("name", PACKAGES)
def test_port_package_has_every_name_of_the_reference_all(name):
    ref = importlib.import_module(name)
    port_name = "repro_torch" + name[len("repro"):]
    port = importlib.import_module(port_name)
    missing = [n for n in ref.__all__ if not hasattr(port, n)
               and importlib.util.find_spec(f"{port_name}.{n}") is None]
    assert not missing, f"{port_name} lacks {missing} of {name}.__all__"


def test_configs_surface_is_the_references():
    from repro.configs import all_cells as j_all_cells, get_shape as j_get_shape
    from repro_torch.configs import SHAPES, all_cells, get_shape
    assert ARCH_IDS == J_ARCH_IDS or set(ARCH_IDS) == set(J_ARCH_IDS)
    for name in SHAPES:
        assert get_shape(name).name == j_get_shape(name).name == name
    for skipped in (False, True):
        assert sorted(all_cells(skipped)) == sorted(j_all_cells(skipped))
    assert len(list(all_cells())) < len(list(all_cells(include_skipped=True)))


class _Axes:
    """A tuple of logical axes as one leaf (``reference_layout`` walks into
    tuples)."""
    def __init__(self, axes):
        self.axes = tuple(axes)


def _ref_cache_tree(tree, cfg, stack):
    """The port's cache tree in the reference's layout (``pos`` beside the
    stacked ``blocks``)."""
    return reference_layout(tree, cfg, stack=stack)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("batch,cache_len", [(8, 2048), (1, 4096)])
def test_abstract_cache_equals_the_references(arch, batch, cache_len):
    """Shapes and dtypes of every cache leaf, at decode shapes."""
    got = _ref_cache_tree(abstract_cache(get_config(arch), batch, cache_len), get_config(arch),
                          lambda ts: (len(ts), *ts[0].shape, str(ts[0].dtype).split(".")[-1]))
    want = j_abstract_cache(j_config(arch), batch, cache_len)
    g, w = list(_leaves(got, is_leaf=lambda x: isinstance(x, tuple))), \
        list(_leaves(want, is_leaf=lambda x: hasattr(x, "shape")))
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        if len(a) and isinstance(a, tuple) and isinstance(a[0], int) and isinstance(a[-1], str):
            assert a == (*b.shape, jnp.dtype(b.dtype).name)      # a stacked block leaf
        else:                                                    # pos
            assert (tuple(a.shape), str(a.dtype).split(".")[-1]) == \
                (tuple(b.shape), jnp.dtype(b.dtype).name)
    assert all(t.device.type == "meta" for t in _leaves(abstract_cache(get_config(arch), 1, 16)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_logical_axes_equal_the_references(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    port = cache_logical_axes(cfg, 8, 2048)
    boxed = {"blocks": [{k: _Axes(v) for k, v in layer.items()} for layer in port["blocks"]],
             "pos": _Axes(port["pos"])}
    got = _ref_cache_tree(boxed, cfg, lambda axs: _Axes(("layer", *axs[0].axes)))
    want = j_cache_logical_axes(jcfg, 8, 2048)
    g = [a.axes for a in _leaves(got, is_leaf=lambda x: isinstance(x, _Axes))]
    w = list(_leaves(want, is_leaf=lambda x: isinstance(x, tuple)))
    assert g == [tuple(x) for x in w]
    assert all(isinstance(a, tuple) for layer in port["blocks"] for a in layer.values())
