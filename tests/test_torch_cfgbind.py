"""The port's config↔control binding helpers (``utils/cfgbind.py``): the
JAX package's cases on the port's module, and every field's grouping,
control kind and coercion held equal to the JAX functions."""

import dataclasses

import pytest

from person_capture_tpu.config import SessionConfig as JaxConfig
from person_capture_tpu.utils import cfgbind as J
from person_capture_tpu_torch.config import LIVE_KEYS, SessionConfig
from person_capture_tpu_torch.utils import cfgbind as T

# the one default the port changes (person_capture_tpu_torch/config.py)
DEFAULTS_CHANGED = {"device": ("tpu", "cuda")}


def test_every_config_field_is_grouped():
    names = {f.name for f in dataclasses.fields(SessionConfig)}
    bound = {n for fields in T.grouped_fields().values() for n, _ in fields}
    missing = names - bound - {"video", "ref", "out_dir"}
    assert not missing, f"fields without a control: {sorted(missing)}"


def test_live_keys_all_bound():
    bound = {n for fields in T.grouped_fields().values() for n, _ in fields}
    assert set(LIVE_KEYS) <= bound


@pytest.mark.parametrize("default,raw,want", [
    (True, "false", False), (False, 1, True), (3, "7", 7),
    (0.5, "0.25", 0.25), ((0.6, 0.3, 0.1), "0.2, 0.3, 0.5", (0.2, 0.3, 0.5)),
    ((1, 2), "(3, 4)", (3, 4)), ("auto", "zscale", "zscale"),
    ("cuda", "cpu", "cpu")])
def test_coerce_round_trip(default, raw, want):
    got = T.coerce_field_value(default, raw)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("default,kind", [
    (True, "check"), (3, "int"), (0.5, "float"), ((1.0, 2.0), "tuple"),
    ("x", "text"), ("cuda", "text")])
def test_widget_kinds(default, kind):
    assert T.widget_kind(default) == kind


@pytest.mark.parametrize("name,section", [
    ("prescan_stride", "Pre-scan"), ("hdr_sdr_tonemap", "HDR"),
    ("curate_lambda", "Curation"), ("lock_momentum", "Lock / faceless"),
    ("device", "General")])
def test_grouping_prefixes(name, section):
    assert T.group_for_field(name) == section


def test_grouped_fields_match_jax():
    """The same sections, fields and order as the JAX package's tab; the
    defaults equal but for the device the port runs on."""
    jax_groups, port_groups = J.grouped_fields(), T.grouped_fields()
    assert list(port_groups) == list(jax_groups)
    for section, fields in jax_groups.items():
        got = port_groups[section]
        assert [n for n, _ in got] == [n for n, _ in fields], section
        for (name, want), (_, have) in zip(fields, got):
            if name in DEFAULTS_CHANGED:
                assert (want, have) == DEFAULTS_CHANGED[name]
            else:
                assert have == want and type(have) is type(want), name


def _raw_inputs(default):
    """What a control can hand back for a field of this default."""
    if isinstance(default, bool):
        return [True, False, "yes", "off", 0]
    if isinstance(default, (int, float)):
        return [default, str(default), "3", "2.5", 7]
    if isinstance(default, tuple):
        return [default, ", ".join(str(v) for v in default), "(1, 2)"]
    return [default, "abc", ""]


def test_kind_and_coercion_of_every_field_match_jax():
    port = {f.name: getattr(SessionConfig(), f.name)
            for f in dataclasses.fields(SessionConfig)}
    jax_cfg = JaxConfig()
    for name, default in port.items():
        jax_default = getattr(jax_cfg, name)
        assert T.widget_kind(default) == J.widget_kind(jax_default), name
        for raw in _raw_inputs(default):
            try:
                want = J.coerce_field_value(default, raw)
            except (ValueError, TypeError) as e:
                with pytest.raises(type(e)):
                    T.coerce_field_value(default, raw)
                continue
            got = T.coerce_field_value(default, raw)
            assert got == want and type(got) is type(want), (name, raw)
