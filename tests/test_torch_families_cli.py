"""The command line takes the families, maps, framings and networks of the
port (`deepxi_tpu_torch.cli` against `deepxi_tpu.cli`, on the CPU): every
Config field both packages have takes the same value for command lines with
`--inp_tgt_type` of each family, `--map_type`/`--map_params`,
`--saved_data_path`, `--T_s` with N_d != 2 N_s and the presets
resnet-1.1n, resnet-1.0c and resnet-1.0n; `--prelim 1` trains ResNet and
ResNetV3; MagPhonemes parses as in the JAX package; the shard flags are
taken as the JAX CLI takes them, and a mesh larger than the process raises
JAX's error."""

import os
import sys

import pytest

from deepxi_tpu_torch import cli

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_cli_checks import assert_config_matches_jax, assert_mesh_refused_as_jax  # noqa: E402

COMMAND_LINES = [
    ["--inp_tgt_type", "MagGamma", "--map_type", "DBNormalCDF"],
    ["--inp_tgt_type", "MagXiGamma", "--map_type", "DBNormalCDF,DBNormalCDF"],
    ["--inp_tgt_type", "MagGain", "--gain", "ibm"],
    ["--inp_tgt_type", "MagMag", "--map_type", "DBMinMaxScaling"],
    ["--inp_tgt_type", "MagSMM", "--loss_fnc", "MeanSquaredError", "--outp_act", "ReLU"],
    ["--inp_tgt_type", "MagPhaXiPha", "--map_type", "DBNormalCDF,UniformCDF",
     "--map_params", "None;neg_pi,pi"],
    ["--inp_tgt_type", "STDCTXiCD", "--map_type", "DBNormalCDF,TruncatedLaplaceCDF",
     "--map_params", "None;0,neg_40,40"],
    ["--map_type", "DBLaplaceCDF", "--map_params", "0"],
    ["--map_type", "Logistic", "--map_params", "0.5,1.0"],
    ["--inp_tgt_type", "MagGamma", "--infer", "1", "--saved_data_path", "out/xi_hat"],
    ["--T_s", "8", "--T_d", "32"],
    ["--T_s", "12", "--T_d", "25", "--f_s", "16000"],
    ["--ver", "resnet-1.1n"], ["--ver", "resnet-1.0c", "--test", "1"],
    ["--ver", "resnet-1.0n-vb", "--train", "1"], ["--ver", "resnet-1.1n-vb"],
    ["--network_type", "ResNetV3", "--unit_type", "LN->ReLU->W+b", "--causal", "0"],
    ["--inp_tgt_type", "MagPhonemes", "--Noutp", "60", "--T_s", "16"],
    ["--inp_tgt_type", "MagPhonme", "--out_type", "hybrid_omlsa", "--infer", "1"],
]


@pytest.mark.parametrize("argv", COMMAND_LINES, ids=range(len(COMMAND_LINES)))
def test_config_from_args_matches_jax(argv):
    assert_config_matches_jax(argv)


@pytest.mark.parametrize("network_type", ["ResNet", "ResNetV3"])
def test_prelim_trains_the_other_resnets(capsys, network_type):
    """`--prelim 1 --network_type ResNet|ResNetV3` trains its small network
    toward 0.75: mean |prediction - target| under 0.12 (the prelim test's
    limit)."""
    assert cli.main(["--prelim", "1", "--platform", "cpu", "--network_type",
                     network_type]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if "mean|pred-target|" in ln]
    assert len(line) == 1 and float(line[0].split()[-1]) < 0.12


@pytest.mark.parametrize("argv", [["--inp_tgt_type", "MagPhonemes", "--n_model_shards", "2"],
                                  ["--inp_tgt_type", "MagPhonme", "--train", "1",
                                   "--n_data_shards", "4"],
                                  ["--out_type", "pho", "--n_model_shards", "8"],
                                  ["--n_data_shards", "2"]])
def test_what_remains_refused_names_its_item(argv):
    """The shard flags, MagPhonemes' flags beside them or not, are taken as
    the JAX CLI takes them, and in a process of one rank `main` raises the
    "exceeds" ValueError of JAX's `make_mesh` on one device."""
    assert_config_matches_jax(argv)
    assert_mesh_refused_as_jax(argv)
