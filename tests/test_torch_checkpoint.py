"""The port's checkpoint store (``repro_torch.checkpoint.store``).

* Every case of ``tests/test_checkpoint.py``, held to the port's store:
  crash-safe writes, manifest validation, separator-safe flat keys, the
  race-tolerant warm-spare reader and the full-train-state layout.
* Across packages: one numpy tree — a smoke ViT's parameters and AdamW
  state in the reference's layout (``repro_torch.bridge``) with a
  control-plane subtree — saved by each store gives identical manifests
  (keys, shapes, dtypes), and each store restores the other's file bit
  for bit, into the reference's own ``AdamWState``.
* A leaf numpy cannot hold without an extension (bfloat16) is refused
  with its key named.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store


def _tree():
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.ones((4,), np.int32)}}


def _like():
    return {"w": np.zeros((2, 3), np.float32),
            "nested": {"b": np.zeros((4,), np.int32)}}


class TestRoundTrip:
    def test_basic_round_trip(self, tmp_path):
        d = str(tmp_path)
        tree = _tree()
        store.save(d, 3, tree)
        assert store.latest_step(d) == 3
        out = store.restore(d, 3, _like())
        np.testing.assert_array_equal(out["w"], tree["w"])
        np.testing.assert_array_equal(out["nested"]["b"], tree["nested"]["b"])

    def test_slash_in_dict_key_round_trips(self, tmp_path):
        d = str(tmp_path)
        tree = {"scan/layer": {"w/down": np.full((3,), 7.0, np.float32)},
                "back\\slash": np.full((2,), 3.0, np.float32)}
        store.save(d, 1, tree)
        like = {"scan/layer": {"w/down": np.zeros((3,), np.float32)},
                "back\\slash": np.zeros((2,), np.float32)}
        out = store.restore(d, 1, like)
        np.testing.assert_array_equal(out["scan/layer"]["w/down"],
                                      tree["scan/layer"]["w/down"])
        np.testing.assert_array_equal(out["back\\slash"], tree["back\\slash"])

    def test_slash_keys_do_not_collide(self, tmp_path):
        d = str(tmp_path)
        tree = {"a": {"b/c": np.asarray([1.0], np.float32)},
                "a/b": {"c": np.asarray([2.0], np.float32)}}
        store.save(d, 1, tree)
        assert len(store.read_manifest(d, 1)["keys"]) == 2
        out = store.restore(d, 1, {"a": {"b/c": np.zeros(1, np.float32)},
                                   "a/b": {"c": np.zeros(1, np.float32)}})
        assert float(out["a"]["b/c"][0]) == 1.0
        assert float(out["a/b"]["c"][0]) == 2.0

    def test_load_arrays_nested(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, {"plane": {"est": {"chi": np.ones(4)}},
                          "params": {"w": np.zeros(2)}})
        out = store.load_arrays(d, 1, prefix="plane")
        np.testing.assert_array_equal(out["est"]["chi"], np.ones(4))
        assert "params" not in out

    def test_restore_casts_to_the_template_dtype_and_keeps_structure(
            self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, {"t": (np.ones(2, np.float32), [np.zeros(1)]),
                          "none": None})
        out = store.restore(d, 1, {"t": (np.zeros(2, np.float64),
                                         [np.zeros(1, np.float32)]),
                                   "none": None})
        assert isinstance(out["t"], tuple) and isinstance(out["t"][1], list)
        assert out["t"][0].dtype == np.float64 and out["none"] is None
        assert store.read_manifest(d, 1)["keys"] == ["t/0", "t/1/0"]


class TestCrashSafety:
    def test_latest_step_skips_manifestless_npz(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, _tree())
        store.save(d, 5, _tree())
        os.unlink(os.path.join(d, "ckpt_00000005.json"))
        assert store.latest_step(d) == 1

    def test_no_tmp_litter_and_no_partial_files(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 2, _tree())
        assert sorted(os.listdir(d)) == ["ckpt_00000002.json",
                                         "ckpt_00000002.npz"]

    def test_overwrite_crash_cannot_pair_new_npz_with_old_manifest(
            self, tmp_path, monkeypatch):
        d = str(tmp_path)
        store.save(d, 1, {"w": np.zeros((2,), np.float32)},
                   extra={"run": "A"})
        orig = store._atomic_write

        def crash_on_manifest(path, fn):
            if path.endswith(".json"):
                raise RuntimeError("crash before manifest commit")
            return orig(path, fn)

        monkeypatch.setattr(store, "_atomic_write", crash_on_manifest)
        with pytest.raises(RuntimeError, match="crash"):
            store.save(d, 1, {"w": np.ones((2,), np.float32)},
                       extra={"run": "B"})
        assert store.latest_step(d) is None

    def test_restore_closes_npz_handle(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, _tree())
        fd_dir = "/proc/self/fd"
        if not os.path.isdir(fd_dir):
            pytest.skip("no /proc fd introspection on this platform")
        before = len(os.listdir(fd_dir))
        for _ in range(5):
            store.restore(d, 1, _like())
        assert len(os.listdir(fd_dir)) <= before + 1


class TestValidation:
    def test_missing_leaf_is_actionable(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, {"w": np.zeros((2,), np.float32)})
        with pytest.raises(KeyError, match="missing leaf"):
            store.restore(d, 1, {"w": np.zeros((2,), np.float32),
                                 "extra": np.zeros((1,), np.float32)})

    def test_shape_mismatch_is_actionable(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, {"w": np.zeros((2, 3), np.float32)})
        with pytest.raises(ValueError, match="shape mismatch"):
            store.restore(d, 1, {"w": np.zeros((3, 2), np.float32)})

    def test_manifest_npz_dtype_disagreement(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, {"w": np.zeros((2,), np.float32)})
        mpath = os.path.join(d, "ckpt_00000001.json")
        man = json.load(open(mpath))
        man["dtypes"]["w"] = "float64"
        with open(mpath, "w") as f:
            json.dump(man, f)
        with pytest.raises(ValueError, match="dtype mismatch"):
            store.restore(d, 1, {"w": np.zeros((2,), np.float32)})

    def test_missing_manifest_is_actionable(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, _tree())
        os.unlink(os.path.join(d, "ckpt_00000001.json"))
        with pytest.raises(FileNotFoundError, match="no manifest"):
            store.restore(d, 1, _tree())

    @pytest.mark.parametrize("leaf", ["torch", "numpy"])
    def test_bf16_leaf_is_refused_with_its_key(self, tmp_path, leaf):
        if leaf == "torch":
            bad = torch.ones(3, dtype=torch.bfloat16)
        else:
            ml_dtypes = pytest.importorskip("ml_dtypes")
            bad = np.ones(3, dtype=ml_dtypes.bfloat16)
        d = str(tmp_path)
        with pytest.raises(TypeError, match="'params/attn/wq'"):
            store.save(d, 1, {"params": {"attn": {"wq": bad}}})
        assert store.latest_step(d) is None


class TestConcurrentReaders:
    def _like(self):
        return {"w": np.zeros((2,), np.float32)}

    def test_load_latest_params_picks_newest_committed(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 1, {"w": np.full((2,), 1.0, np.float32)})
        store.save(d, 5, {"w": np.full((2,), 5.0, np.float32)})
        step, params = store.load_latest_params(d, self._like())
        assert step == 5
        np.testing.assert_array_equal(params["w"], np.full((2,), 5.0))

    def test_empty_or_missing_directory_is_a_clean_miss(self, tmp_path):
        assert store.load_latest_params(str(tmp_path), self._like()) \
            == (None, None)
        assert store.load_latest_params(
            os.path.join(str(tmp_path), "never_made"), self._like()) \
            == (None, None)

    def test_orphan_npz_is_skipped_mid_save(self, tmp_path):
        d = str(tmp_path)
        store.save(d, 2, {"w": np.full((2,), 2.0, np.float32)})
        store.save(d, 9, {"w": np.full((2,), 9.0, np.float32)})
        os.unlink(os.path.join(d, "ckpt_00000009.json"))
        assert store.latest_step(d) == 2
        step, params = store.load_latest_params(d, self._like())
        assert step == 2
        np.testing.assert_array_equal(params["w"], np.full((2,), 2.0))

    def test_manifest_retracted_between_scan_and_read(self, tmp_path,
                                                      monkeypatch):
        d = str(tmp_path)
        store.save(d, 3, {"w": np.full((2,), 3.0, np.float32)})
        store.save(d, 7, {"w": np.full((2,), 7.0, np.float32)})
        orig = store.read_manifest

        def retracted(directory, step):
            if step == 7:
                raise FileNotFoundError(
                    f"checkpoint step {step} in {directory} has no "
                    "manifest")
            return orig(directory, step)

        monkeypatch.setattr(store, "read_manifest", retracted)
        step, params = store.load_latest_params(d, self._like())
        assert step == 3
        np.testing.assert_array_equal(params["w"], np.full((2,), 3.0))

    def test_reader_gives_up_on_a_churning_directory(self, tmp_path,
                                                     monkeypatch):
        d = str(tmp_path)
        for s in range(1, 5):
            store.save(d, s, {"w": np.full((2,), float(s), np.float32)})
        monkeypatch.setattr(
            store, "read_manifest",
            lambda directory, step: (_ for _ in ()).throw(
                FileNotFoundError("no manifest")))
        with pytest.raises(RuntimeError, match="kept changing"):
            store.load_latest_params(d, self._like(), retries=2)


class TestTrainStateLayout:
    def test_prefix_restore_and_load_params(self, tmp_path):
        d = str(tmp_path)
        params = {"w": np.full((2,), 5.0, np.float32)}
        opt = {"mu": {"w": np.full((2,), 0.5, np.float32)}}
        store.save(d, 7, {"params": params, "opt": opt},
                   extra={"layout": store.TRAIN_STATE_LAYOUT,
                          "train_step": 7})
        like = {"w": np.zeros((2,), np.float32)}
        out = store.restore(d, 7, like, prefix="params")
        np.testing.assert_array_equal(out["w"], params["w"])
        out2 = store.load_params(d, 7, like)
        np.testing.assert_array_equal(out2["w"], params["w"])

    def test_load_params_legacy_layout(self, tmp_path):
        d = str(tmp_path)
        params = {"w": np.full((3,), 2.0, np.float32)}
        store.save(d, 2, params)
        out = store.load_params(d, 2, {"w": np.zeros((3,), np.float32)})
        np.testing.assert_array_equal(out["w"], params["w"])

    def test_train_state_layout_tag_matches_the_reference(self):
        from repro.checkpoint import store as jstore
        assert store.TRAIN_STATE_LAYOUT == jstore.TRAIN_STATE_LAYOUT


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _train_state_tree():
    """A smoke ViT's parameters and a stepped AdamW state, both in the
    reference's layout, plus a control-plane subtree of the kinds the
    trainer checkpoints (float64, int64, bool)."""
    from repro_torch import bridge
    from repro_torch.config import get_config, smoke_variant
    from repro_torch.models import vit as tvit
    from repro_torch.optim import adamw
    cfg = smoke_variant(get_config("vit-1b"))
    model = tvit.init(torch.Generator().manual_seed(0), cfg, torch.float32,
                      "cpu")
    opt = adamw.init(dict(model.named_parameters()))
    g = torch.Generator().manual_seed(1)
    for t in list(opt.mu.values()) + list(opt.nu.values()):
        t.copy_(torch.rand(t.shape, generator=g))
    opt = adamw.AdamWState(step=3, mu=opt.mu, nu=opt.nu)
    plane = {"controller": {"t_avg": np.asarray(0.25),
                            "pri": {"ffn": {"w_var": np.arange(4.0),
                                            "pruned_last": np.zeros(4, bool)}}},
             "estimator": {"counters": np.arange(3, dtype=np.int64)}}
    return cfg, {"params": bridge.vit_params_to_numpy(model),
                 "opt": bridge.adamw_state_to_numpy(opt, cfg),
                 "plane": plane}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_zeros_like(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return np.zeros_like(tree)


def _assert_same_bits(a, b, path="tree"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_bits(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_bits(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


def test_manifests_and_files_agree_across_packages(tmp_path):
    """One tree saved by each store: identical keys, shapes and dtypes,
    and each store restores the other's file bit for bit (the optimizer
    state into the reference's own ``AdamWState``)."""
    import jax
    from repro.checkpoint import store as jstore
    from repro.optim.adamw import AdamWState as JAdamWState
    _, tree = _train_state_tree()
    extra = {"layout": store.TRAIN_STATE_LAYOUT, "train_step": 3}
    dt, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    store.save(dt, 3, tree, extra=extra)
    jstore.save(dj, 3, tree, extra=extra)
    mt, mj = store.read_manifest(dt, 3), jstore.read_manifest(dj, 3)
    for k in ("keys", "shapes", "dtypes", "extra", "step"):
        assert mt[k] == mj[k], k
    assert "opt/step" in mt["keys"] and "opt/mu/cls" in mt["keys"]
    assert "params/stack/scan/0/ffn/w_up" in mt["keys"]

    like = _zeros_like({k: tree[k] for k in ("params", "opt")})
    for sub in ("params", "opt"):
        # the port's store reads the reference's file, and the converse
        _assert_same_bits(store.restore(dj, 3, like[sub], prefix=sub),
                          tree[sub], sub)
        jlike = like[sub]
        if sub == "opt":
            jlike = JAdamWState(*like["opt"])
        got = jstore.restore(dt, 3, jlike, prefix=sub)
        if sub == "opt":
            assert isinstance(got, JAdamWState)
        _assert_same_bits(jax.tree.map(np.asarray, got), tree[sub], sub)
    _assert_same_bits(store.load_arrays(dj, 3, "plane"),
                      jstore.load_arrays(dt, 3, "plane"), "plane")
    _assert_same_bits(store.load_params(dj, 3, like["params"]),
                      tree["params"], "load_params")
