"""`mnn_tpu_torch.sass_diff.instructions` reads `cuobjdump -sass` output: the
function names and every instruction line with its address, five hex digits
and more past 0xffff included, without the encoding's second line. The
hashes in an anonymous namespace's mangled name, which differ between two
trees, are blanked. The compile and the dump need nvcc and cuobjdump, so
they are not run here."""

from mnn_tpu_torch import sass_diff

SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _ZN3mnn16dqmm_gemv_kernelILi4EEEvPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*fff0*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
                                                                          /* 0x000e220000002100 */
        /*10000*/                  EXIT ;                                 /* 0x000000000000794d */
                                                                          /* 0x000fea0003800000 */
		..........
"""


def test_instructions_reads_names_and_every_address():
    got = sass_diff.instructions(SASS)
    assert got[0] == "Function : _ZN3mnn16dqmm_gemv_kernelILi4EEEvPK13__nv_bfloat16"
    assert [x.split()[0] for x in got[1:]] == ["/*0000*/", "/*fff0*/", "/*10000*/"]
    assert got[3].split()[1] == "EXIT"
    assert sass_diff.instructions(SASS.replace("S2R R0", "S2R R2")) != got


ANON = "_ZN3mnn47_GLOBAL__N__{}_14_decode_step_cu_{}18decode_step_kernelILi128EaLi1EEEvPKi"


def test_instructions_blank_anonymous_namespace_hashes():
    def dump(a, b):
        return SASS.replace("_ZN3mnn16dqmm_gemv_kernelILi4EEEvPK13__nv_bfloat16",
                            ANON.format(a, b))
    got = sass_diff.instructions(dump("aa1480e7", "d0c757ef"))
    assert got == sass_diff.instructions(dump("0123abcd", "89abcdef"))
    assert got[0] == "Function : " + ANON.format("########", "########")
    assert got != sass_diff.instructions(dump("aa1480e7", "d0c757ef").replace("Li128E", "Li64E"))


def test_common_functions_compare_one_by_one():
    """`--common` splits the dump into functions and compares those both
    versions have: a kernel one version adds, or the order of the
    functions, changes nothing; an instruction changed in a shared one is
    named."""
    second = SASS.replace("dqmm_gemv_kernelILi4EE", "dqmm_gemv_kernelILi8EE")
    new = sass_diff.instructions(SASS + second.split("code for sm_90a")[1])
    old = sass_diff.instructions(SASS)
    same, diff, mine, theirs = sass_diff.compare_common(new, old)
    gemv4 = "_ZN3mnn16dqmm_gemv_kernelILi4EEEvPK13__nv_bfloat16"
    gemv8 = gemv4.replace("Li4E", "Li8E")
    assert (same, diff, mine, theirs) == ([gemv4], [], [gemv8], [])
    assert list(sass_diff.functions(new)) == [gemv4, gemv8]
    assert len(sass_diff.functions(new)[gemv8]) == 3
    changed = sass_diff.instructions(SASS.replace("S2R R0", "S2R R2"))
    assert sass_diff.compare_common(changed, new)[1] == [gemv4]
    assert sass_diff.compare_common(new[4:] + new[:4], new)[:2] == ([gemv4, gemv8], [])
