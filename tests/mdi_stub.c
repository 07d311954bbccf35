/* A scripted stand-in for the MolSSI MDI library, for driving an engine's
 * serve_libmdi loop without libmdi (as the reference's own mdi_stub build
 * does).  Build: cc -shared -fPIC -o libfake_mdi.so mdi_stub.c
 *
 * MDI_Recv_command hands out the commands of $FAKE_MDI_SEQ (comma
 * separated, default "<NATOMS,<FORCES,<ENERGY,EXIT") in order, then
 * fails.  MDI_Send appends (count, dtype, data) to $FAKE_MDI_OUT.
 * MDI_Recv fills double k with 1e-3 * (k % 7 - 3) (ints with 0). */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

const int MDI_COMMAND_LENGTH_ = 12;
const int MDI_INT_ = 0;
const int MDI_DOUBLE_ = 1;
static char seq_[1024];
static char *next_ = NULL;
static FILE *out_ = NULL;

int MDI_Init(const char *opts) {
  const char *p = getenv("FAKE_MDI_OUT");
  const char *s = getenv("FAKE_MDI_SEQ");
  strncpy(seq_, s ? s : "<NATOMS,<FORCES,<ENERGY,EXIT", sizeof(seq_) - 1);
  next_ = seq_;
  out_ = fopen(p ? p : "fake_mdi.bin", "wb");
  return out_ ? 0 : 1;
}
int MDI_Register_node(const char *n) { return 0; }
int MDI_Register_command(const char *n, const char *c) { return 0; }
int MDI_Accept_communicator(int *comm) {
  *comm = 1;
  return 0;
}
int MDI_Recv_command(char *buf, int comm) {
  if (next_ == NULL || *next_ == '\0') return 1;
  char *end = strchr(next_, ',');
  size_t len = end ? (size_t)(end - next_) : strlen(next_);
  memset(buf, 0, MDI_COMMAND_LENGTH_);
  memcpy(buf, next_, len < 11 ? len : 11);
  next_ = end ? end + 1 : next_ + len;
  return 0;
}
int MDI_Send(const void *data, int count, int dtype, int comm) {
  int bytes = count * (dtype == MDI_DOUBLE_ ? 8 : 4);
  fwrite(&count, 4, 1, out_);
  fwrite(&dtype, 4, 1, out_);
  fwrite(data, 1, bytes, out_);
  fflush(out_);
  return 0;
}
int MDI_Recv(void *data, int count, int dtype, int comm) {
  if (dtype == MDI_DOUBLE_) {
    for (int k = 0; k < count; ++k)
      ((double *)data)[k] = 1e-3 * (k % 7 - 3);
  } else {
    memset(data, 0, count * 4);
  }
  return 0;
}
