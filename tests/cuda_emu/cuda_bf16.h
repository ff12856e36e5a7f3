#pragma once
#include "cuda_emu.h"
