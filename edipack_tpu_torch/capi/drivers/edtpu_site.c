/* One impurity through the edtpu_* API (edipack_tpu.h).
 *
 *   edtpu_site INPUT_FILE NSPIN NORB LMATS
 *
 * Reads the configuration from INPUT_FILE (edtpu_read_input; NSPIN, NORB
 * and LMATS are its values, which size the buffers), solves one site with
 * a zero Hloc and the default bath, statics only (flag_gf 0), then in
 * full, and prints one line per quantity, "NAME count v1 v2 ...": EVALS
 * (the kept levels), DENS, DOCC, MAGZ, EIMP, and G (the Matsubara G on
 * the default grid, interleaved re/im, C order [Nspin,Nspin,Norb,Norb,L]).
 * The device comes from EDIPACK_TPU_TORCH_DEVICE. Exits 1 on the first
 * error, printing "ERR message". */
#include <stdio.h>
#include <stdlib.h>

#include "edipack_tpu.h"

static int fail(void) {
  printf("ERR %s\n", edtpu_last_error());
  return 1;
}

static void put(const char *name, const double *v, int n) {
  printf("%s %d", name, n);
  for (int i = 0; i < n; ++i) printf(" %.17g", v[i]);
  printf("\n");
}

int main(int argc, char **argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s INPUT_FILE NSPIN NORB LMATS\n", argv[0]);
    return 2;
  }
  int nspin = atoi(argv[2]), norb = atoi(argv[3]), lmats = atoi(argv[4]);
  int nso = nspin * norb, ng = nso * nso * lmats;
  if (edtpu_init() || edtpu_read_input(argv[1])) return fail();
  int nb = edtpu_get_bath_dimension();
  if (nb < 0) return fail();
  double *bath = malloc(sizeof(double) * nb);
  double *hre = calloc(nso * nso, sizeof(double));
  double *buf = malloc(sizeof(double) * (2 * ng + 4096));
  int n = 0;
  if (edtpu_init_solver(bath, nb) || edtpu_set_hloc(hre, NULL, nso))
    return fail();
  if (edtpu_solve_flag(bath, nb, 0)) return fail();
  if (edtpu_solve(bath, nb)) return fail();
  if (edtpu_get_evals(buf, &n, 4096)) return fail();
  put("EVALS", buf, n);
  if (edtpu_get_dens(buf, norb)) return fail();
  put("DENS", buf, norb);
  if (edtpu_get_docc(buf, norb)) return fail();
  put("DOCC", buf, norb);
  if (edtpu_get_mag("z", buf, norb)) return fail();
  put("MAGZ", buf, norb);
  if (edtpu_get_eimp(buf)) return fail();
  put("EIMP", buf, 4);
  if (edtpu_get_gimp_axis("m", "n", buf, ng)) return fail();
  put("G", buf, 2 * ng);
  free(bath);
  free(hre);
  free(buf);
  edtpu_finalize();
  return 0;
}
